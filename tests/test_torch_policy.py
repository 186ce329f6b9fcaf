"""The port's ActorCritic against the Flax one on the runs/r4_go1 weights,
the Normal-distribution helpers against JAX's, and a short CPU rollout.

Float32 matrix products accumulate in another order in XLA and PyTorch;
through four layers of up to 630 inputs outputs agree to rtol 1e-4 /
atol 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu import RLTPU_ROOT_DIR
from rapid_locomotion_rl_tpu.models import networks as JN
from rapid_locomotion_rl_tpu.utils.checkpoint import load_pytree as jload
from rapid_locomotion_rl_tpu_torch.config import config_go1
from rapid_locomotion_rl_tpu_torch.convert import params_from_flax
from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
from rapid_locomotion_rl_tpu_torch.learn.ppo import PPOArgs, rollout
from rapid_locomotion_rl_tpu_torch.models import networks as TN
from rapid_locomotion_rl_tpu_torch.sampler import Sampler
from rapid_locomotion_rl_tpu_torch.utils.checkpoint import load_pytree

WEIGHTS = os.path.join(RLTPU_ROOT_DIR, "runs", "r4_go1", "checkpoints",
                       "ac_weights_last.pkl")
DIMS = (42, 18, 630, 12)   # obs, privileged obs, obs history, actions


@pytest.fixture(scope="module", params=[0.0, 0.5], ids=["min_std0",
                                                        "min_std0.5"])
def nets(request):
    tree = load_pytree(WEIGHTS)
    jac = JN.ActorCritic(*DIMS, JN.ACArgs(min_std=request.param))
    tac = TN.ActorCritic(*DIMS, TN.ACArgs(min_std=request.param))
    tac.load_state_dict(params_from_flax(tree["params"]))
    rng = np.random.default_rng(0)
    x = [rng.normal(0, 1, (32, d)).astype(np.float32) for d in DIMS[:3]]
    return jac, tree, tac, x


def test_checkpoint_loads_same_tree():
    a, b = jload(WEIGHTS), load_pytree(WEIGHTS)
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb) == 29
    for u, v in zip(la, lb):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("head", ["act_teacher", "act_student", "evaluate",
                                  "distribution"])
def test_heads_match_flax(nets, head):
    jac, tree, tac, (obs, priv, hist) = nets
    second = hist if head == "act_student" else priv
    ref = jac.apply(tree, jnp.asarray(obs), jnp.asarray(second),
                    method=getattr(JN.ActorCritic, head))
    with torch.no_grad():
        out = getattr(tac, head)(torch.tensor(obs), torch.tensor(second))
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


def test_normal_helpers_match_jax():
    rng = np.random.default_rng(1)
    mu0, x = (rng.normal(0, 1, (8, 12)).astype(np.float32)
               for _ in range(2))
    s0 = rng.uniform(0.2, 2, (8, 12)).astype(np.float32)
    j, t = jnp.asarray, torch.tensor
    np.testing.assert_allclose(
        TN.normal_log_prob(t(mu0), t(s0), t(x)).numpy(),
        np.asarray(JN.normal_log_prob(j(mu0), j(s0), j(x))), rtol=1e-5)
    np.testing.assert_allclose(
        TN.normal_entropy(t(s0)).numpy(),
        np.asarray(JN.normal_entropy(j(s0))), rtol=1e-5)


def test_cpu_rollout_shapes_and_finite():
    """3 steps of the Go1 teacher-policy rollout at 16 envs on the CPU."""
    cfg = config_go1()
    cfg.env.num_envs = 16
    env = LeggedRobotEnv(cfg, device="cpu")
    ac = TN.ActorCritic(env.num_obs, env.num_privileged_obs,
                        env.num_obs_history, env.num_actions,
                        TN.ACArgs(min_std=0.0))
    ac.load_state_dict(params_from_flax(load_pytree(WEIGHTS)["params"]))
    sampler = Sampler(0, "cpu")
    state = env.initial_state(sampler)
    state, traj, info = rollout(env, ac, PPOArgs(), state, sampler, 3)
    T, n = 3, 16
    want = {"obs": (T, n, 42), "privileged_obs": (T, n, 18),
            "obs_history": (T, n, 630), "actions": (T, n, 12),
            "rewards": (T, n), "dones": (T, n), "values": (T, n),
            "log_prob": (T, n), "mu": (T, n, 12), "sigma": (T, n, 12),
            "env_bins": (T, n)}
    for name, shape in want.items():
        v = getattr(traj, name)
        assert tuple(v.shape) == shape, name
        if v.is_floating_point():
            assert torch.isfinite(v).all(), name
    for k, v in info.items():
        assert v.shape[0] == T and torch.isfinite(v.float()).all(), k
    assert torch.isfinite(state.sim.base_pos).all()
    # the trained policy keeps Go1 up for these steps
    assert not traj.dones.any()
    assert (state.sim.base_pos[:, 2] > 0.2).all()


@pytest.mark.parametrize("act,use_latent", [("elu", True), ("tanh", False)])
def test_fresh_init_matches_flax(act, use_latent):
    """A fresh ActorCritic is initialised as Flax's (LeCun-normal kernels,
    zero biases, std 1): the same tree, each kernel's standard deviation
    within 10% of the Flax init's, no entry past two standard deviations
    of the truncated normal, on the flagship's and the HLP's
    architectures."""
    dims = DIMS if use_latent else (14, 18, 16, 3)
    jac = JN.ActorCritic(*dims, JN.ACArgs(activation=act,
                                          use_latent=use_latent))
    tree = jac.init(jax.random.PRNGKey(0),
                    *(jnp.zeros((1, d)) for d in dims[:3]))
    ref = params_from_flax(jax.tree.map(np.asarray, tree)["params"])
    torch.manual_seed(0)
    got = TN.ActorCritic(*dims, TN.ACArgs(activation=act,
                                          use_latent=use_latent)
                         ).state_dict()
    assert set(got) == set(ref)
    for k, v in got.items():
        if k.endswith(".bias"):
            assert torch.all(v == 0) and torch.all(ref[k] == 0), k
        elif k == "std":
            assert torch.equal(v, ref[k])
        else:
            fan_in = v.shape[1]
            assert abs(v.std().item() / ref[k].std().item() - 1) < 0.1, k
            assert v.abs().max().item() <= 2.0 / np.sqrt(fan_in) / .8796, k
