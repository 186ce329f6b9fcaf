"""The port's PPO update (rapid_locomotion_rl_tpu_torch.learn.ppo) against
the JAX package's: GAE, two consecutive minibatch updates from the
runs/r5_flagship weights, the metric keys of one training iteration, and
that policy's heads.

Both sides get the same numpy trajectory and the same minibatch
permutation (JAX's, replayed through the port's sampler). The JAX update
runs jitted on the CPU. Float32 matrix products and their gradients sum in
another order in XLA and PyTorch (tests/test_torch_policy.py: rtol 1e-4 /
atol 1e-5 on outputs). Losses, KL and the sysid residuals agree to rtol
1e-4, the learning rate exactly. Adam divides each gradient entry by its
own running magnitude, so an entry whose batch sum nearly cancels takes a
step of up to the learning rate in a direction set by float rounding: the
updated parameters agree in bulk, >= 99.9% of every tensor's entries
within 1e-5 (measured: all but 1 in 4,600 at worst), and every entry
within 1e-3, the first step's learning rate."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu import RLTPU_ROOT_DIR
from rapid_locomotion_rl_tpu.learn import ppo as JP
from rapid_locomotion_rl_tpu.models import networks as JN
from rapid_locomotion_rl_tpu_torch.convert import params_from_flax
from rapid_locomotion_rl_tpu_torch.learn import ppo as TP
from rapid_locomotion_rl_tpu_torch.models import networks as TN
from rapid_locomotion_rl_tpu_torch.sampler import Sampler
from rapid_locomotion_rl_tpu_torch.utils.checkpoint import load_pytree

WEIGHTS = os.path.join(RLTPU_ROOT_DIR, "runs", "r5_flagship", "checkpoints",
                       "ac_weights_last.pkl")
DIMS = (42, 18, 630, 12)   # obs, privileged obs, obs history, actions
T, N, NTRAIN, NBINS = 4, 72, 64, 9
OBS_SCALE = 0.3


class PermSampler(Sampler):
    def __init__(self, perm):
        super().__init__(0, "cpu")
        self.perm = perm

    def permutation(self, name, n):
        assert name == "ppo/minibatch" and n == self.perm.numel()
        return self.perm


def _traj(jac, params, seed=0):
    """A [T, N] trajectory whose actions, log-probs and values come from the
    policy itself (so the first minibatch's KL is ~0, as in training)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    obs, priv, hist = (f(T, N, d) * OBS_SCALE for d in DIMS[:3])
    mean, std = jac.apply(params, obs, priv,
                          method=JN.ActorCritic.distribution)
    mean, std = np.asarray(mean), np.asarray(std)
    actions = (mean + std * f(T, N, 12)).astype(np.float32)
    values = np.asarray(jac.apply(params, obs, priv,
                                  method=JN.ActorCritic.evaluate))
    log_prob = np.asarray(JN.normal_log_prob(mean, std, actions))
    return JP.Transition(
        obs=obs, privileged_obs=priv, obs_history=hist, actions=actions,
        rewards=rng.normal(0.02, 0.05, (T, N)).astype(np.float32),
        dones=rng.uniform(size=(T, N)) < 0.1, values=values,
        log_prob=log_prob, mu=mean, sigma=std,
        env_bins=rng.integers(0, NBINS, (T, N)).astype(np.int32))


def _torch_traj(traj):
    return TP.Transition(*(torch.tensor(np.asarray(x)) for x in traj))


def test_compute_gae_matches_jax():
    rng = np.random.default_rng(3)
    fields = {f: rng.normal(0, 1, (24, 16)).astype(np.float32)
              for f in JP.Transition._fields}
    fields["dones"] = rng.uniform(size=(24, 16)) < 0.2
    traj = JP.Transition(**fields)
    last = rng.normal(0, 1, 16).astype(np.float32)
    ja, jr = JP.compute_gae(JP.Transition(*map(jnp.asarray, traj)),
                            jnp.asarray(last), 0.99, 0.95)
    ta, tr = TP.compute_gae(_torch_traj(traj), torch.tensor(last), 0.99,
                            0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def two_updates():
    """Two consecutive updates in each package (the second from a non-zero
    Adam state) on the same trajectory and permutation, with the per-bin
    sysid residuals on and a per-iteration entropy coefficient."""
    args = JP.PPOArgs()
    tree = load_pytree(WEIGHTS)
    jac = JN.ActorCritic(*DIMS, JN.ACArgs(min_std=0.2))
    tx, adapt_tx = JP.make_optimizers(args)
    jstate = JP.PPOState(params=tree, opt_state=tx.init(tree),
                         adapt_opt_state=adapt_tx.init(tree),
                         lr=jnp.asarray(args.learning_rate, jnp.float32))
    traj = _traj(jac, tree)
    jtraj = JP.Transition(*map(jnp.asarray, traj))
    last = jnp.asarray(np.random.default_rng(1).normal(0, 1, N), jnp.float32)
    adv, ret = JP.compute_gae(jtraj, last, args.gamma, args.lam)
    key = jax.random.PRNGKey(7)
    upd = jax.jit(lambda s, k: JP.ppo_update(
        jac, args, s, jtraj, adv, ret, k, NTRAIN, num_curriculum_bins=NBINS,
        entropy_coef=0.005))
    j1, jm1 = upd(jstate, key)
    j2, jm2 = upd(j1, key)
    perm = torch.tensor(np.asarray(jax.random.permutation(
        key, (T * NTRAIN // 4) * 4)))

    tac = TN.ActorCritic(*DIMS, TN.ACArgs(min_std=0.2))
    tac.load_state_dict(params_from_flax(tree["params"]))
    targs = TP.PPOArgs()
    tstate = TP.init_ppo_state(tac, targs)
    tadv, tret = torch.tensor(np.asarray(adv)), torch.tensor(np.asarray(ret))
    out = []
    for _ in range(2):
        tstate, tm = TP.ppo_update(tac, targs, tstate, _torch_traj(traj),
                                   tadv, tret, PermSampler(perm), NTRAIN,
                                   num_curriculum_bins=NBINS,
                                   entropy_coef=0.005)
        out.append((tm, {k: v.detach().clone()
                         for k, v in tac.state_dict().items()}))
    return [(jm1, j1), (jm2, j2)], out


@pytest.mark.parametrize("which", [0, 1], ids=["first", "second"])
def test_ppo_update_metrics_match(two_updates, which):
    jax_out, torch_out = two_updates
    jm, _ = jax_out[which]
    tm, _ = torch_out[which]
    assert set(tm) == set(jm)
    assert float(jm["kl"]) > 0.0
    for k in ("mean_value_loss", "mean_surrogate_loss",
              "mean_adaptation_loss", "kl", "mean_noise_std"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert tm["lr"].item() == float(jm["lr"])
    np.testing.assert_array_equal(tm["sysid_residual_count"].numpy(),
                                  np.asarray(jm["sysid_residual_count"]))
    np.testing.assert_allclose(tm["sysid_residual_sum"].numpy(),
                               np.asarray(jm["sysid_residual_sum"]),
                               rtol=1e-4)


@pytest.mark.parametrize("which", [0, 1], ids=["first", "second"])
def test_ppo_update_params_match(two_updates, which):
    jax_out, torch_out = two_updates
    _, jstate = jax_out[which]
    _, tparams = torch_out[which]
    ref = params_from_flax(jax.tree.map(np.asarray, jstate.params)["params"])
    assert set(ref) == set(tparams)
    moved = 0.0
    before = params_from_flax(load_pytree(WEIGHTS)["params"])
    for k in ref:
        err = (tparams[k] - ref[k]).abs()
        assert (err <= 1e-5).float().mean().item() >= 0.999, k
        assert err.max().item() <= 1e-3, (k, err.max().item())
        moved = max(moved, (ref[k] - before[k]).abs().max().item())
    assert moved > 1e-3, "the update should move the parameters"


def test_adaptive_lr_rule():
    """Floor 1e-5, cap max_lr, and no change for a KL of 0."""
    a = TP.PPOArgs()
    assert TP._adaptive_lr(1.2e-5, 1.0, a) == float(np.float32(1e-5))
    assert TP._adaptive_lr(9e-3, 1e-4, a) == float(np.float32(1e-2))
    assert TP._adaptive_lr(1e-3, 0.0, a) == float(np.float32(1e-3))
    assert TP._adaptive_lr(1e-3, 0.01, a) == float(np.float32(1e-3))


def test_train_iteration_metric_keys_match_jax():
    """One port training iteration on a small trimesh CPU env
    (config_mini_cheetah, 2 x 2 cells, 8 envs, 2 steps at decimation 1)
    gives JAX make_train_iteration's metric keys, except the ``_render/*``
    pose log, which is not ported. The JAX keys come from jax.eval_shape
    (the AoS physics traces in seconds; nothing is compiled)."""
    from rapid_locomotion_rl_tpu import config as jcfg
    from rapid_locomotion_rl_tpu.envs.legged_robot import LeggedRobotEnv as JE
    from rapid_locomotion_rl_tpu_torch import config as tcfg
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    cfgs = []
    for mod in (jcfg, tcfg):
        c = mod.config_mini_cheetah()
        c.env.num_envs = 8
        c.terrain.num_rows = c.terrain.num_cols = 2
        c.terrain.border_size = 5.0
        c.control.decimation = 1
        c.sim.physics_impl = "aos"
        cfgs.append(c)
    jenv = JE(cfgs[0])
    jac = JN.ActorCritic(*DIMS, JN.ACArgs())
    args = JP.PPOArgs()
    jst = jax.eval_shape(jenv.initial_state, jax.random.PRNGKey(0))
    jps = jax.eval_shape(lambda k: JP.init_ppo_state(k, jac, args, *DIMS[:3]),
                         jax.random.PRNGKey(0))
    _, _, jm = jax.eval_shape(JP.make_train_iteration(jenv, jac, args, 2),
                              jst, jps, jax.random.PRNGKey(1))

    env = LeggedRobotEnv(cfgs[1], device="cpu")
    ac = TN.ActorCritic(*DIMS, TN.ACArgs())
    ac.load_state_dict(params_from_flax(load_pytree(WEIGHTS)["params"]))
    sampler = Sampler(0, "cpu")
    state = env.initial_state(sampler)
    ps = TP.init_ppo_state(ac, TP.PPOArgs())
    timings = {}
    state, ps, tm = TP.train_iteration(env, ac, TP.PPOArgs(), state, ps,
                                       sampler, entropy_coef=0.0,
                                       num_steps=2, timings=timings)
    want = {k for k in jm if not k.startswith("_render/")}
    assert set(tm) == want
    for k, v in tm.items():
        assert tuple(v.shape) == tuple(jm[k].shape), k
        assert torch.isfinite(v.float()).all(), k
    assert np.float32(1e-5) <= ps.lr <= args.max_lr
    assert ps.opt.param_groups[0]["lr"] == ps.lr, ps.opt.param_groups[0]["lr"]
    assert set(timings) == {"rollout_s", "update_s"}
    assert all(torch.isfinite(p).all() for p in ac.parameters())


@pytest.mark.parametrize("head", ["act_teacher", "act_student", "evaluate"])
def test_flagship_heads_match_flax(head):
    """The runs/r5_flagship policy's teacher and student actions and its
    value head against Flax's, at the tolerance of
    tests/test_torch_policy.py (rtol 1e-4 / atol 1e-5)."""
    tree = load_pytree(WEIGHTS)
    jac = JN.ActorCritic(*DIMS, JN.ACArgs(min_std=0.2))
    tac = TN.ActorCritic(*DIMS, TN.ACArgs(min_std=0.2))
    tac.load_state_dict(params_from_flax(tree["params"]))
    rng = np.random.default_rng(4)
    obs, priv, hist = (rng.normal(0, OBS_SCALE, (32, d)).astype(np.float32)
                       for d in DIMS[:3])
    second = hist if head == "act_student" else priv
    ref = jac.apply(tree, jnp.asarray(obs), jnp.asarray(second),
                    method=getattr(JN.ActorCritic, head))
    with torch.no_grad():
        out = getattr(tac, head)(torch.tensor(obs), torch.tensor(second))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
