"""The flagship's training entry of the port (scripts/train_cuda.py, the
port's Runner on the legged env) against scripts/train.py and the JAX
package's Runner and update.

- train_cuda.py has every flag of train.py but the three that choose
  among JAX back ends and shard over chips (--physics-impl, --mesh,
  --distributed), with the same defaults, types and choices, and one of
  its own, --device.
- A 2-iteration ``--device cpu`` run on a small trimesh config (2 x 3
  cells, 16 envs, one substep and decimation 1, 0.1 s episodes so that
  every env resets) writes exactly the metric keys of
  runs/r5_flagship/metrics.jsonl, and resuming its own checkpoint carries
  on at iteration 2.
- The Runner's entropy ramp (0 -> 0.01 over 300 iterations, a float32
  value per iteration), its curriculum-dump and checkpoint cadence and
  the random initial episode lengths, against the JAX Runner's learn
  driven over the same iterations.
- One update from runs/r5_flagship's full PPO state (params, both Adam
  states, the LR) in each package, on a synthetic trajectory whose env
  bins are curriculum bins that the flagship's envs hold: losses, KL and
  the per-bin sysid residuals at rtol 1e-4, the LR exactly, the params by
  the bulk rule of tests/test_torch_ppo.py (>= 99.9% of each tensor
  within 1e-5, all within 1e-3). The full 4000-env state is loaded only
  on the card (chip_smoke.py); here only its PPO state."""

import argparse
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu import RLTPU_ROOT_DIR
from rapid_locomotion_rl_tpu.learn import ppo as JP
from rapid_locomotion_rl_tpu.models import networks as JN
from rapid_locomotion_rl_tpu.utils.checkpoint import load_pytree as jload
from rapid_locomotion_rl_tpu_torch import convert
from rapid_locomotion_rl_tpu_torch.learn import ppo as TP
from rapid_locomotion_rl_tpu_torch.learn import runner as TR
from rapid_locomotion_rl_tpu_torch.models import networks as TN
from rapid_locomotion_rl_tpu_torch.sampler import Sampler
from rapid_locomotion_rl_tpu_torch.utils.checkpoint import load_pytree

RUN = os.path.join(RLTPU_ROOT_DIR, "runs", "r5_flagship")
STATE = os.path.join(RUN, "checkpoints", "train_state_last.pkl")
LEFT_OUT = {"--physics-impl", "--mesh", "--distributed"}


def _script(name):
    path = os.path.join(RLTPU_ROOT_DIR, "scripts", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def _parser(monkeypatch, call):
    """The ArgumentParser that ``call`` builds, caught at parse_args."""
    seen = {}

    def grab(self, *a, **k):
        seen["p"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        call()
    return seen["p"]


def _flags(parser):
    return {a.option_strings[-1]: (type(a).__name__, a.default, a.type,
                                   a.choices, a.nargs, a.const)
            for a in parser._actions if a.option_strings[-1] != "--help"}


def test_flags_match_train_py(monkeypatch):
    ref = _flags(_parser(monkeypatch, _script("train.py").main))
    got = _flags(_parser(monkeypatch, _script("train_cuda.py").parse_args))
    assert LEFT_OUT <= set(ref)
    assert set(got) - set(ref) == {"--device"}
    assert got["--device"][1] == "cuda"
    assert set(ref) - set(got) == LEFT_OUT
    for flag in set(ref) - LEFT_OUT:
        assert got[flag] == ref[flag], flag


def test_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    mod = _script("train_cuda.py")
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.build_runner(mod.parse_args(["--logdir", "unused"]))


def _small_script():
    """train_cuda.py whose config is cut to a CPU-sized trimesh."""
    mod = _script("train_cuda.py")
    make = mod.make_cfg

    def small(args):
        c = make(args)
        c.terrain.num_rows, c.terrain.num_cols = 2, 3
        c.terrain.border_size = 5.0
        c.control.decimation = 1
        c.env.episode_length_s = 0.1
        return c
    mod.make_cfg = small
    return mod


SMALL = ["--device", "cpu", "--num-envs", "16", "--substeps", "1"]


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    logdir = tmp_path_factory.mktemp("train_cuda")
    runner = _small_script().main(SMALL + ["--iterations", "2", "--logdir",
                                           str(logdir)])
    return runner, logdir


def _keys(path):
    with open(path) as f:
        return set().union(*(json.loads(x) for x in f)) - {"_timestamp"}


def test_cpu_run_writes_r5_flagship_keys(cpu_run):
    runner, logdir = cpu_run
    assert runner.env.cfg.terrain.mesh_type == "trimesh"
    assert runner.env.cfg.sim.num_substeps == 1
    assert (runner.current_learning_iteration, runner.tot_timesteps) == (
        2, 2 * 24 * 16)
    got = _keys(logdir / "metrics.jsonl")
    assert got == _keys(os.path.join(RUN, "metrics.jsonl"))
    for f in ("parameters.json", "curriculum/info.pkl",
              "checkpoints/train_state_last.pkl",
              "checkpoints/train_state_000001.pkl",
              "checkpoints/ac_weights_last.pkl",
              "checkpoints/student_policy_latest.pt2"):
        assert (logdir / f).exists(), f
    # iteration 0 is on the 400 video cadence
    assert (logdir / "videos" / "00000.gif").stat().st_size > 2_000
    with open(logdir / "parameters.json") as f:
        ra = json.load(f)["RunnerArgs"]
    assert (ra["max_iterations"], ra["save_video_interval"]) == (2, 400)


def test_resume_own_checkpoint_continues(cpu_run, tmp_path):
    runner, logdir = cpu_run
    mod = _small_script()
    path = str(logdir / "checkpoints" / "train_state_last.pkl")
    argv = SMALL + ["--iterations", "1", "--resume", path, "--logdir",
                    str(tmp_path)]
    r2 = mod.build_runner(mod.parse_args(argv))
    assert (r2.current_learning_iteration, r2.tot_timesteps) == (
        2, runner.tot_timesteps)
    assert torch.equal(r2.sampler.generator.get_state(),
                       runner.sampler.generator.get_state())
    for a, b in zip(runner.ac.parameters(), r2.ac.parameters()):
        assert torch.equal(a, b)
    r3 = mod.main(argv)
    assert (r3.current_learning_iteration, r3.tot_timesteps) == (
        3, 3 * 24 * 16)
    assert (tmp_path / "checkpoints" / "train_state_000002.pkl").exists()


def _cadence(runner, set_train_iter, n=4, start=298):
    """Drive ``runner.learn`` over iterations ``start..start+n-1`` with its
    train iteration, eval reset, curriculum dump, video and checkpoint
    stubbed; return what each was called with, in order, and the episode
    lengths the first train iteration saw."""
    events, seen = [], []

    def train_iter(env_state, entropy_coef):
        events.append(("train", float(entropy_coef)))
        if not seen:
            seen.append(np.asarray(env_state.episode_length))

    set_train_iter(train_iter)
    runner._reset_eval = lambda s: (events.append(("eval",)), s)[1]
    runner._dump_curriculum = lambda it: events.append(("dump", it))
    runner._log_video = lambda it: events.append(("video", it))
    runner.save_checkpoint = lambda it, final=False: events.append(
        ("save", it, final))
    runner.current_learning_iteration = start
    runner.learn(n, init_at_random_ep_len=True, eval_freq=100)
    assert runner.current_learning_iteration == start + n
    return events, seen[0]


def test_entropy_ramp_and_cadence_match_jax_runner(monkeypatch, tmp_path):
    """Iterations 298-301 of each package's Runner.learn, built as its
    entry script builds it (PPO defaults, RunnerArgs(max_iterations,
    save_video_interval=400)), with the train iteration and the cadence's
    calls stubbed: the same entropy coefficients (the ramp 0 -> 0.01 over
    300 iterations, a float32 value per iteration), the same curriculum
    dumps, eval resets, videos and checkpoints, in the same order. The
    episode lengths start random in [0, max_episode_length) in both. The
    JAX env is Mini Cheetah on the plane at 16 envs, which the cadence
    does not read, so that it builds in seconds on the CPU."""
    from rapid_locomotion_rl_tpu.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu.envs.legged_robot import LeggedRobotEnv
    from rapid_locomotion_rl_tpu.learn.ppo import PPOArgs as JPPOArgs
    from rapid_locomotion_rl_tpu.learn.runner import Runner as JRunner
    from rapid_locomotion_rl_tpu.learn.runner import RunnerArgs as JRArgs

    c = config_mini_cheetah()
    c.env.num_envs = 16
    c.terrain.mesh_type = "plane"
    c.terrain.teleport_robots = False
    jenv = LeggedRobotEnv(c)
    jrunner = JRunner(jenv, logdir=str(tmp_path / "jax"), seed=0,
                      ppo_args=JPPOArgs(),
                      runner_args=JRArgs(max_iterations=4,
                                         save_video_interval=400))

    def set_jax(f):
        def train_iter(env_state, ppo_state, key, entropy_coef=None):
            f(env_state, entropy_coef)
            return env_state, ppo_state, {"kl": jnp.float32(0.01)}
        jrunner._train_iter = train_iter
    want, jep = _cadence(jrunner, set_jax)

    mod = _small_script()
    runner = mod.build_runner(mod.parse_args(
        SMALL + ["--iterations", "4", "--logdir", str(tmp_path / "port")]))

    def set_port(f):
        def train_iteration(env, ac, ppo_args, env_state, ppo_state, sampler,
                            entropy_coef=None, **kw):
            f(env_state, entropy_coef)
            return env_state, ppo_state, {"kl": torch.tensor(0.01)}
        monkeypatch.setattr(TR, "train_iteration", train_iteration)
    got, ep = _cadence(runner, set_port)

    assert ("dump", 300) in want
    assert got == want
    for lengths, env in ((jep, jenv), (ep, runner.env)):
        assert 0 <= lengths.min() and \
            lengths.max() < env.derived.max_episode_length
        assert len(set(lengths.tolist())) > 1


# ---------------------------------------------------------------------------
DIMS = (42, 18, 630, 12)   # obs, privileged obs, obs history, actions
T, NR, NTRAIN = 4, 72, 64


class PermSampler(Sampler):
    def __init__(self, perm):
        super().__init__(0, "cpu")
        self.perm = perm

    def permutation(self, name, n):
        assert name == "ppo/minibatch" and n == self.perm.numel()
        return self.perm


def _run_args(mod):
    with open(os.path.join(RUN, "parameters.json")) as f:
        p = json.load(f)
    return mod.ACArgs(**p["AC_Args"]), p["PPO_Args"]


@pytest.fixture(scope="module")
def resumed_updates():
    """One update from r5_flagship's PPO state in each package (the JAX one
    jitted on the CPU) on a [T, N] trajectory made by the policy itself,
    with the adaptation step, the per-bin residuals over the flagship's
    5202 curriculum bins, and the same minibatch permutation."""
    payload = jload(STATE)
    jstate = payload["ppo_state"]
    nbins = int(np.asarray(payload["env_state"].curriculum.weights).shape[0])
    held = np.asarray(payload["env_state"].env_command_bins)[:9]
    ac_args, ppo = _run_args(JN)
    jargs = JP.PPOArgs(**ppo)
    jac = JN.ActorCritic(*DIMS, ac_args)
    params = jstate.params
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    obs, priv, hist = (f(T, NR, d) * 0.3 for d in DIMS[:3])
    mean, std = jac.apply(params, obs, priv,
                          method=JN.ActorCritic.distribution)
    mean, std = np.asarray(mean), np.asarray(std)
    actions = (mean + std * f(T, NR, 12)).astype(np.float32)
    values = np.asarray(jac.apply(params, obs, priv,
                                  method=JN.ActorCritic.evaluate))
    traj = JP.Transition(
        obs=obs, privileged_obs=priv, obs_history=hist, actions=actions,
        rewards=rng.normal(0.02, 0.05, (T, NR)).astype(np.float32),
        dones=rng.uniform(size=(T, NR)) < 0.05, values=values,
        log_prob=np.asarray(JN.normal_log_prob(mean, std, actions)),
        mu=mean, sigma=std,
        env_bins=rng.choice(held, (T, NR)).astype(np.int32))
    jtraj = JP.Transition(*map(jnp.asarray, traj))
    last = jnp.asarray(rng.normal(0, 1, NR), jnp.float32)
    adv, ret = JP.compute_gae(jtraj, last, jargs.gamma, jargs.lam)
    key = jax.random.PRNGKey(5)
    j1, jm = jax.jit(lambda s, k: JP.ppo_update(
        jac, jargs, s, jtraj, adv, ret, k, NTRAIN,
        num_curriculum_bins=nbins, entropy_coef=0.01))(
        jax.tree.map(jnp.asarray, jstate), key)
    perm = torch.tensor(np.asarray(jax.random.permutation(
        key, (T * NTRAIN // 4) * 4)))

    tac = TN.ActorCritic(*DIMS, _run_args(TN)[0])
    targs = TP.PPOArgs(**ppo)
    ts = convert.ppo_state_from_jax(load_pytree(STATE)["ppo_state"], tac,
                                    targs)
    lr0 = ts.lr
    ts, tm = TP.ppo_update(
        tac, targs, ts, TP.Transition(*(torch.tensor(np.asarray(x))
                                        for x in traj)),
        torch.tensor(np.asarray(adv)), torch.tensor(np.asarray(ret)),
        PermSampler(perm), NTRAIN, num_curriculum_bins=nbins,
        entropy_coef=0.01)
    return (jstate, j1, jm), (lr0, ts, tm, tac), held


def _adam(opt_state):
    """The optax Adam state (count, mu, nu) inside a chain's state."""
    if hasattr(opt_state, "nu"):
        return opt_state
    found = [a for x in opt_state if isinstance(x, tuple)
             for a in [_adam(x)] if a is not None]
    return found[0] if found else None


def test_resumed_flagship_state_loads_like_jax(resumed_updates):
    """Both converted Adam states are JAX's (count and moments), and the
    LR is the carried one."""
    (jstate, _, _), (lr0, _, _, _), _ = resumed_updates
    assert lr0 == float(np.asarray(jstate.lr))
    assert 1e-5 < lr0 < 1e-3
    tac = TN.ActorCritic(*DIMS, _run_args(TN)[0])
    ts = convert.ppo_state_from_jax(load_pytree(STATE)["ppo_state"], tac,
                                    TP.PPOArgs())
    adam, adapt = _adam(jstate.opt_state), _adam(jstate.adapt_opt_state)
    adapt_names = {f"adaptation_module.{n}" for n, _ in
                   tac.adaptation_module.named_parameters()}
    assert adapt_names
    for name, p in tac.named_parameters():
        opt, ref = ((ts.adapt_opt, adapt) if name in adapt_names
                    else (ts.opt, adam))
        st = opt.state[p]
        assert float(st["step"]) == float(adam.count) > 0
        for field, moment in (("exp_avg", ref.mu), ("exp_avg_sq", ref.nu)):
            leaf = convert._flax_leaf(moment["params"], name)
            np.testing.assert_array_equal(
                st[field].numpy(),
                leaf.T if name.endswith(".weight") else leaf)


def test_resumed_flagship_update_matches_jax(resumed_updates):
    (_, j1, jm), (lr0, ts, tm, tac), held = resumed_updates
    assert set(tm) == set(jm)
    for k in ("mean_value_loss", "mean_surrogate_loss",
              "mean_adaptation_loss", "kl", "mean_noise_std"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert tm["mean_adaptation_loss"].item() > 0.0
    assert tm["lr"].item() == float(jm["lr"]) == ts.lr
    count = tm["sysid_residual_count"].numpy()
    np.testing.assert_array_equal(count,
                                  np.asarray(jm["sysid_residual_count"]))
    assert set(np.nonzero(count)[0]) == set(held.tolist())
    np.testing.assert_allclose(tm["sysid_residual_sum"].numpy(),
                               np.asarray(jm["sysid_residual_sum"]),
                               rtol=1e-4)
    ref = convert.params_from_flax(jax.tree.map(np.asarray,
                                                j1.params)["params"])
    got = tac.state_dict()
    assert set(ref) == set(got)
    before = convert.params_from_flax(jload(STATE)["ppo_state"]
                                      .params["params"])
    moved = 0.0
    for k in ref:
        err = (got[k] - ref[k]).abs()
        assert (err <= 1e-5).float().mean().item() >= 0.999, k
        assert err.max().item() <= 1e-3, (k, err.max().item())
        moved = max(moved, (ref[k] - before[k]).abs().max().item())
    assert moved > 1e-5, "the update should move the parameters"
