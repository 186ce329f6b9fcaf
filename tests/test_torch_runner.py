"""The port's Runner, checkpoints and resume (rapid_locomotion_rl_tpu_torch.
learn.runner, .utils.checkpoint, .convert) against the JAX package's.

- A 2-iteration CPU run of the port's Runner on a small HLP config writes
  the metric keys that the JAX Runner writes for the same config (the JAX
  Runner's own _log_iteration on its train iteration's metrics, whose
  shapes come from jax.eval_shape: nothing is compiled), and these are
  runs/r5_hlp7's keys.
- A checkpoint written by the port reads back to equal tensors.
- ``rollout`` with eval envs against JAX's on a replayed draw: train envs
  sample, eval envs act through the deterministic teacher or student.
- The update resumed from runs/r5_hlp7's full train state (params, both
  Adam states, the LR) against JAX's update from the same state: losses
  and KL at rtol 1e-4, the LR exactly, the params in bulk by the rule of
  tests/test_torch_ppo.py (>= 99.9% of each tensor within 1e-5, all
  within 1e-3).
- The JAX package's train states of runs/r4_flagship_4000 and
  runs/r5_flagship load in a process where jax, optax and the JAX package
  cannot be imported."""

import json
import os
import subprocess
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu import RLTPU_ROOT_DIR
from rapid_locomotion_rl_tpu import config as jcfg
from rapid_locomotion_rl_tpu.envs import hlp as JH
from rapid_locomotion_rl_tpu.envs.legged_robot import LeggedRobotEnv as JEnv
from rapid_locomotion_rl_tpu.learn import ppo as JP
from rapid_locomotion_rl_tpu.learn import runner as JR
from rapid_locomotion_rl_tpu.models import networks as JN
from rapid_locomotion_rl_tpu.utils.checkpoint import load_pytree as jload
from rapid_locomotion_rl_tpu_torch import config as tcfg
from rapid_locomotion_rl_tpu_torch import convert
from rapid_locomotion_rl_tpu_torch.envs import hlp as TH
from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
from rapid_locomotion_rl_tpu_torch.learn import ppo as TP
from rapid_locomotion_rl_tpu_torch.learn import runner as TR
from rapid_locomotion_rl_tpu_torch.models import networks as TN
from rapid_locomotion_rl_tpu_torch.sampler import Sampler
from rapid_locomotion_rl_tpu_torch.utils.checkpoint import load_pytree

RUNS = os.path.join(RLTPU_ROOT_DIR, "runs")
HLP_STATE = os.path.join(RUNS, "r5_hlp7", "checkpoints",
                         "train_state_last.pkl")
LL_STATE = os.path.join(RUNS, "r4_flagship_4000", "checkpoints",
                        "train_state_last.pkl")
DIMS = (14, 18, 16, 3)     # HLP obs, privileged obs, obs history, actions
N = 8


def _hlp_run_args(mod):
    """r5_hlp7's AC_Args and PPO_Args (its parameters.json)."""
    with open(os.path.join(RUNS, "r5_hlp7", "parameters.json")) as f:
        p = json.load(f)
    return mod.ACArgs(**p["AC_Args"]), p["PPO_Args"]


def _cfg(mod):
    c = mod.config_mini_cheetah()
    c.env.num_envs = N
    c.env.auto_reset = False
    c.terrain.mesh_type = "plane"
    c.terrain.teleport_robots = False
    c.noise.add_noise = False
    c.domain_rand.push_robots = False
    c.commands.command_curriculum = False
    c.control.decimation = 1
    c.sim.physics_impl = "aos"
    return c


def _scales(mod):
    class Scales(mod.HLPRewardScales):
        progress = 1.0
    return Scales


# r5_hlp7's flags, but a goal disc of 10 m: every env reaches its goal and
# resets at every step, so that both episode-metric channels are written
HLP_FLAGS = dict(zero_reward_on_reset=False, dead_zone=0.0, goal_radius=10.0)


@pytest.fixture(scope="module")
def ll_params():
    return jload(LL_STATE)["ppo_state"].params


def _port_hlp_env(ll_params):
    ll = LeggedRobotEnv(_cfg(tcfg), device="cpu")
    ac = TN.ActorCritic(ll.num_obs, ll.num_privileged_obs,
                        ll.num_obs_history, ll.num_actions, TN.ACArgs())
    ac.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, ll_params)["params"]))
    env = TH.HighLevelControlEnv(ll, ac, scales=_scales(TH), **HLP_FLAGS)
    env.cfg, env.derived = ll.cfg, ll.derived
    return env


def _runner(env, logdir, seed=0):
    ac_args, ppo = _hlp_run_args(TN)
    return TR.Runner(env, logdir=str(logdir), ac_args=ac_args,
                     ppo_args=TP.PPOArgs(**ppo),
                     runner_args=TR.RunnerArgs(num_steps_per_env=2,
                                               log_freq=1),
                     seed=seed, eval_expert=True)


def _keys(path):
    with open(path) as f:
        return set().union(*(json.loads(x) for x in f)) - {"_timestamp"}


@pytest.fixture(scope="module")
def port_run(ll_params, tmp_path_factory):
    """Two iterations of 2 steps of the port's Runner (CPU)."""
    env = _port_hlp_env(ll_params)
    logdir = tmp_path_factory.mktemp("port_run")
    runner = _runner(env, logdir)
    runner.learn(2, eval_freq=1)
    return env, runner, logdir


def test_runner_metric_keys_match_jax_and_r5_hlp7(ll_params, port_run,
                                                  tmp_path):
    env, runner, logdir = port_run
    got = _keys(logdir / "metrics.jsonl")
    assert runner.current_learning_iteration == 2
    assert len(runner.timings) == 2

    # the JAX Runner on the same HLP config: its own logging of its train
    # iteration's metrics (shapes from eval_shape; one env of each kind
    # reset, so that both episode channels are written)
    jll = JEnv(_cfg(jcfg))
    jenv = JH.HighLevelControlEnv(jll, ll_params, scales=_scales(JH),
                                  **HLP_FLAGS)
    jenv.cfg, jenv.derived = jll.cfg, jll.derived
    ac_args, ppo = _hlp_run_args(JN)
    jr = JR.Runner(jenv, logdir=str(tmp_path), ac_args=ac_args,
                   ppo_args=JP.PPOArgs(**ppo),
                   runner_args=JR.RunnerArgs(num_steps_per_env=2,
                                             log_freq=1),
                   eval_expert=True)
    shapes = jax.eval_shape(lambda s, p, k: jr._train_iter(s, p, k)[2],
                            jr.env_state, jr.ppo_state,
                            jax.random.PRNGKey(0))
    fake = {k: np.ones(v.shape, v.dtype) for k, v in shapes.items()}
    jr._log_iteration(0, fake)
    want = _keys(tmp_path / "metrics.jsonl")
    assert got == want, (sorted(got - want), sorted(want - got))
    assert got == _keys(os.path.join(RUNS, "r5_hlp7", "metrics.jsonl"))


def test_checkpoint_round_trip(port_run, tmp_path):
    """Save, then load_checkpoint into a fresh Runner: equal params, Adam
    states, LR, env state, sampler state, iteration and step count."""
    env, runner, logdir = port_run
    path = logdir / "checkpoints" / "train_state_last.pkl"
    for f in ("train_state_000001.pkl", "ac_weights_last.pkl",
              "ac_weights_000001.pkl", "student_policy_latest.params.pkl"):
        assert (logdir / "checkpoints" / f).exists(), f
    r2 = _runner(env, tmp_path, seed=1)
    r2.load_checkpoint(str(path))
    for (k, a), b in zip(runner.ac.state_dict().items(),
                         r2.ac.state_dict().values()):
        assert torch.equal(a, b), k
    p2 = dict(r2.ac.named_parameters())
    for k, p in runner.ac.named_parameters():
        s1, s2 = runner.ppo_state.opt.state[p], r2.ppo_state.opt.state[p2[k]]
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s1[f], s2[f]), (k, f)
    assert r2.ppo_state.lr == runner.ppo_state.lr
    assert r2.ppo_state.opt.param_groups[0]["lr"] == runner.ppo_state.lr
    assert (r2.current_learning_iteration, r2.tot_timesteps) == (
        runner.current_learning_iteration, runner.tot_timesteps)
    assert torch.equal(r2.sampler.generator.get_state(),
                       runner.sampler.generator.get_state())
    a = jax.tree_util.tree_leaves(convert.state_to_jax(runner.env_state))
    b = jax.tree_util.tree_leaves(convert.state_to_jax(r2.env_state))
    assert len(a) == len(b) > 80
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # the weights file is the Flax tree that the JAX play scripts read
    flax = load_pytree(str(logdir / "checkpoints" / "ac_weights_last.pkl"))
    assert set(flax["params"]) == {"actor_body", "critic_body", "std"}
    assert flax["params"]["actor_body"]["Dense_0"]["kernel"].shape == (14,
                                                                       512)


# ---------------------------------------------------------------------------
class ToyState(NamedTuple):
    obs: object
    privileged_obs: object
    obs_history: object


class ToyResult(NamedTuple):
    obs: object
    privileged_obs: object
    obs_history: object
    rew: object
    done: object
    info: dict


class _Toy:
    """A linear env, the same in both frameworks: the rollout's eval-env
    logic without the physics. 7 envs: 5 train, 2 eval."""
    num_envs, num_train_envs, num_eval_envs = 7, 5, 2

    def __init__(self, xp):
        self.xp = xp

    def step(self, s, a, sampler=None):
        xp = self.xp
        cat = (xp.concatenate if xp is jnp else torch.cat)
        obs = cat([s.obs[:, :3] * 0.9 + 0.1 * a, s.obs[:, 3:] * 0.95], -1)
        rew = -xp.sum(a * a, -1)
        done = rew < -4.0
        info = {"time_outs": done & (rew < -6.0),
                "env_bins": (xp.zeros(7, dtype=xp.int32)),
                "big_count": xp.sum(done)}
        st = ToyState(obs, s.privileged_obs, s.obs_history)
        return st, ToyResult(obs, s.privileged_obs, s.obs_history, rew, done,
                             info)


class NoiseReplay(Sampler):
    def __init__(self, noises):
        super().__init__(0, "cpu")
        self.noises = list(noises)

    def normal(self, name, shape):
        assert name == "action"
        return self.noises.pop(0)


@pytest.mark.parametrize("eval_expert", [True, False])
def test_rollout_eval_envs_match_jax(eval_expert):
    tree = jload(HLP_STATE)["ppo_state"].params
    ac_args, _ = _hlp_run_args(JN)
    jac = JN.ActorCritic(*DIMS, ac_args)
    tac = TN.ActorCritic(*DIMS, _hlp_run_args(TN)[0])
    tac.load_state_dict(convert.params_from_flax(tree["params"]))
    rng = np.random.default_rng(0)
    s0 = [rng.normal(0, 1, (7, d)).astype(np.float32) for d in DIMS[:3]]
    key = jax.random.PRNGKey(4)
    T = 3
    _, jtraj, jinfo, _ = JP.rollout(
        _Toy(jnp), jac, JP.PPOArgs(), tree,
        ToyState(*map(jnp.asarray, s0)), key, T, eval_expert)
    noises, k = [], key
    for _ in range(T):
        k, ks = jax.random.split(k)
        noises.append(torch.tensor(np.asarray(
            jax.random.normal(ks, (7, 3)))))
    _, ttraj, tinfo = TP.rollout(
        _Toy(torch), tac, TP.PPOArgs(), ToyState(*map(torch.tensor, s0)),
        NoiseReplay(noises), T, eval_expert)
    for f in ("actions", "mu", "sigma", "log_prob", "values", "rewards",
              "obs"):
        np.testing.assert_allclose(getattr(ttraj, f).numpy(),
                                   np.asarray(getattr(jtraj, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(ttraj.dones.numpy(),
                                  np.asarray(jtraj.dones))
    np.testing.assert_array_equal(tinfo["big_count"].numpy(),
                                  np.asarray(jinfo["big_count"]))
    # the eval envs act deterministically, the train envs do not
    a, mu = ttraj.actions.numpy(), ttraj.mu.numpy()
    head = tac.act_teacher if eval_expert else tac.act_student
    second = ttraj.privileged_obs if eval_expert else ttraj.obs_history
    with torch.no_grad():
        det = head(ttraj.obs[:, 5:].reshape(-1, 14),
                   second[:, 5:].reshape(-1, second.shape[-1]))
    np.testing.assert_allclose(a[:, 5:].reshape(-1, 3), det.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert np.abs(a[:, :5] - mu[:, :5]).min() > 0.0


# ---------------------------------------------------------------------------
T, NR, NTRAIN = 4, 72, 64


class PermSampler(Sampler):
    def __init__(self, perm):
        super().__init__(0, "cpu")
        self.perm = perm

    def permutation(self, name, n):
        assert name == "ppo/minibatch" and n == self.perm.numel()
        return self.perm


@pytest.fixture(scope="module")
def resumed_updates():
    """One update from r5_hlp7's train state in each package (the JAX one
    jitted on the CPU), on a [T, N] trajectory made by the policy itself
    and the same minibatch permutation."""
    payload = jload(HLP_STATE)
    jstate = payload["ppo_state"]
    ac_args, ppo = _hlp_run_args(JN)
    jargs = JP.PPOArgs(**ppo)
    jac = JN.ActorCritic(*DIMS, ac_args)
    params = jstate.params
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    obs, priv, hist = (f(T, NR, d) * 0.3 for d in DIMS[:3])
    mean, std = jac.apply(params, obs, priv,
                          method=JN.ActorCritic.distribution)
    mean, std = np.asarray(mean), np.asarray(std)
    actions = (mean + std * f(T, NR, 3)).astype(np.float32)
    values = np.asarray(jac.apply(params, obs, priv,
                                  method=JN.ActorCritic.evaluate))
    traj = JP.Transition(
        obs=obs, privileged_obs=priv, obs_history=hist, actions=actions,
        rewards=rng.normal(-0.01, 0.05, (T, NR)).astype(np.float32),
        dones=rng.uniform(size=(T, NR)) < 0.05, values=values,
        log_prob=np.asarray(JN.normal_log_prob(mean, std, actions)),
        mu=mean, sigma=std, env_bins=np.zeros((T, NR), np.int32))
    jtraj = JP.Transition(*map(jnp.asarray, traj))
    last = jnp.asarray(rng.normal(0, 1, NR), jnp.float32)
    adv, ret = JP.compute_gae(jtraj, last, jargs.gamma, jargs.lam)
    key = jax.random.PRNGKey(11)
    j1, jm = jax.jit(lambda s, k: JP.ppo_update(
        jac, jargs, s, jtraj, adv, ret, k, NTRAIN))(
        jax.tree.map(jnp.asarray, jstate), key)
    perm = torch.tensor(np.asarray(jax.random.permutation(
        key, (T * NTRAIN // 4) * 4)))

    tac = TN.ActorCritic(*DIMS, _hlp_run_args(TN)[0])
    targs = TP.PPOArgs(**ppo)
    ts = convert.ppo_state_from_jax(load_pytree(HLP_STATE)["ppo_state"],
                                    tac, targs)
    lr0 = ts.lr
    ts, tm = TP.ppo_update(
        tac, targs, ts, TP.Transition(*(torch.tensor(np.asarray(x))
                                        for x in traj)),
        torch.tensor(np.asarray(adv)), torch.tensor(np.asarray(ret)),
        PermSampler(perm), NTRAIN)
    return (jstate, j1, jm), (lr0, ts, tm, tac)


def test_resumed_state_loads_like_jax(resumed_updates):
    """The converted Adam state is JAX's: count, moments, LR."""
    (jstate, _, _), (lr0, _, _, _) = resumed_updates
    assert lr0 == float(np.asarray(jstate.lr))
    assert 1e-5 <= lr0 <= 1e-3
    tac = TN.ActorCritic(*DIMS, _hlp_run_args(TN)[0])
    ts = convert.ppo_state_from_jax(load_pytree(HLP_STATE)["ppo_state"],
                                    tac, TP.PPOArgs())
    adam = jstate.opt_state[1][0]
    for name, p in tac.named_parameters():
        st = ts.opt.state[p]
        assert float(st["step"]) == float(adam.count)
        ref = convert._flax_leaf(adam.nu["params"], name)
        np.testing.assert_array_equal(
            st["exp_avg_sq"].numpy(),
            ref.T if name.endswith(".weight") else ref)
    assert ts.adapt_opt is None     # use_latent=False: no adaptation step


def test_resumed_update_matches_jax(resumed_updates):
    (_, j1, jm), (lr0, ts, tm, tac) = resumed_updates
    assert set(tm) == set(jm)
    for k in ("mean_value_loss", "mean_surrogate_loss", "kl",
              "mean_noise_std"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert tm["mean_adaptation_loss"].item() == float(
        jm["mean_adaptation_loss"]) == 0.0
    assert tm["lr"].item() == float(jm["lr"]) == ts.lr
    ref = convert.params_from_flax(jax.tree.map(np.asarray,
                                                j1.params)["params"])
    got = tac.state_dict()
    assert set(ref) == set(got)
    before = convert.params_from_flax(jload(HLP_STATE)["ppo_state"]
                                      .params["params"])
    moved = 0.0
    for k in ref:
        err = (got[k] - ref[k]).abs()
        assert (err <= 1e-5).float().mean().item() >= 0.999, k
        assert err.max().item() <= 1e-3, (k, err.max().item())
        moved = max(moved, (ref[k] - before[k]).abs().max().item())
    assert moved > 1e-5, "the update should move the parameters"


BLOCKED = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "rapid_locomotion_rl_tpu"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
from rapid_locomotion_rl_tpu_torch import convert
from rapid_locomotion_rl_tpu_torch.learn.ppo import PPOArgs
from rapid_locomotion_rl_tpu_torch.models.networks import ACArgs, ActorCritic
from rapid_locomotion_rl_tpu_torch.utils.checkpoint import load_pytree
for run in ("r4_flagship_4000", "r5_flagship"):
    p = load_pytree(f"runs/{run}/checkpoints/train_state_last.pkl")
    ac = ActorCritic(42, 18, 630, 12, ACArgs())
    ps = convert.ppo_state_from_jax(p["ppo_state"], ac, PPOArgs())
    env = convert.state_from_jax(p["env_state"], device="cpu")
    n = sum(len(s) for s in ps.opt.state.values())
    print(run, p["iteration"], env.obs.shape[0], n, ps.lr)
print("MODULES", sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "optax", "flax")))
"""


def test_jax_train_states_load_without_jax():
    env = dict(os.environ, PYTHONPATH=RLTPU_ROOT_DIR)
    out = subprocess.run([sys.executable, "-c", BLOCKED], cwd=RLTPU_ROOT_DIR,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.split("\n")
    assert lines[0].split()[:3] == ["r4_flagship_4000", "4000", "4000"]
    assert lines[1].split()[:3] == ["r5_flagship", "4000", "4000"]
    # every parameter of both optimizer groups has its Adam moments
    assert all(int(x.split()[3]) > 0 for x in lines[:2])
    assert "MODULES []" in out.stdout
