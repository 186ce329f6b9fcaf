"""The two halves of the port's training iteration and its throughput entry
(bench_cuda.py) against the JAX package's (learn/ppo.py's
make_train_functions, bench.py).

- make_train_functions' rollout+GAE and update halves, composed, equal
  train_iteration bit for bit over two iterations on a 2 x 3-cell trimesh
  with one substep and decimation 1 (test_torch_train.py's small config);
  two rollouts from one env state with equal Samplers are equal (the env
  step changes nothing in place, which the bench's phase split needs).
- The update half against JAX's update half, one update from
  runs/r5_flagship's PPO state on test_torch_train.py's trajectory, at
  that file's tolerances.
- bench_cuda.main with --device cpu at BENCH_SIZES=8 (config_mini_cheetah
  cut to that small trimesh by monkeypatching, 1 timed iteration of 4
  steps per env): exactly one stdout line, equal to bench.py's _emit for
  the same figure; the stderr lines of the size.
- The environment variables it reads are bench.py's, with their defaults;
  _emit equals bench.py's.
- Without a card and without --device cpu it exits 3 with no JSON line.
"""

import copy
import importlib.util
import json
import os
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as TT
from rapid_locomotion_rl_tpu import RLTPU_ROOT_DIR
from rapid_locomotion_rl_tpu.learn import ppo as JP
from rapid_locomotion_rl_tpu_torch import config as TC
from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
from rapid_locomotion_rl_tpu_torch.learn import ppo as TP
from rapid_locomotion_rl_tpu_torch.models.networks import ACArgs, ActorCritic
from rapid_locomotion_rl_tpu_torch.sampler import Sampler

BENCH = os.path.join(RLTPU_ROOT_DIR, "bench.py")
BENCH_CUDA = os.path.join(RLTPU_ROOT_DIR, "bench_cuda.py")
STEPS = 3


def _load(path):
    name = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_cfg(make=TC.config_mini_cheetah):
    """The flagship config cut to test_torch_train.py's CPU size."""
    c = make()
    c.terrain.num_rows, c.terrain.num_cols = 2, 3
    c.terrain.border_size = 5.0
    c.control.decimation = 1
    c.sim.num_substeps = 1
    c.env.episode_length_s = 0.1
    return c


@pytest.fixture(scope="module")
def small_env():
    c = small_cfg()
    c.env.num_envs = 16
    return LeggedRobotEnv(c, device="cpu")


def _equal(a, b, what):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


def test_halves_compose_to_train_iteration(small_env):
    env = small_env
    torch.manual_seed(0)
    ac_a = ActorCritic(env.num_obs, env.num_privileged_obs,
                       env.num_obs_history, env.num_actions, ACArgs())
    ac_b = copy.deepcopy(ac_a)
    args = TP.PPOArgs()
    ps_a, ps_b = TP.init_ppo_state(ac_a, args), TP.init_ppo_state(ac_b, args)
    st_a = st_b = env.initial_state(Sampler(0, "cpu"))
    s_a, s_b = Sampler(1, "cpu"), Sampler(1, "cpu")
    rollout_gae, update = TP.make_train_functions(env, ac_b, args, STEPS)
    for it in range(2):
        timings = {}
        st_a, ps_a, m_a = TP.train_iteration(
            env, ac_a, args, st_a, ps_a, s_a, entropy_coef=0.005 * it,
            num_steps=STEPS, timings=timings)
        st_b, traj, adv, ret, m_roll = rollout_gae(st_b, s_b)
        ps_b, m_upd = update(ps_b, traj, adv, ret, s_b,
                             entropy_coef=0.005 * it)
        assert set(timings) == {"rollout_s", "update_s"}
        assert traj.obs.shape[:2] == (STEPS, env.num_envs)
        assert {f"_render/{k}" for k in ("pos", "quat", "q", "origin")
                } <= set(m_roll)
        _equal(m_a, {**m_roll, **m_upd}, f"metrics {it}")
        _equal(tuple(st_a), tuple(st_b), f"env state {it}")
        assert ps_a.lr == ps_b.lr
    _equal(ac_a.state_dict(), ac_b.state_dict(), "parameters")
    # two rollouts from one state, equal draws: equal (no in-place write)
    one = rollout_gae(st_b, Sampler(2, "cpu"))
    two = rollout_gae(st_b, Sampler(2, "cpu"))
    _equal(tuple(one[0]), tuple(two[0]), "end state")
    _equal(tuple(one[1]), tuple(two[1]), "trajectory")
    _equal(one[4], two[4], "rollout metrics")


def test_update_half_matches_jax():
    """JAX's make_train_functions update (jitted on the CPU) and the
    port's, each built on an env that holds the flagship's curriculum
    bins and the trajectory's train envs."""
    (jstate, jac, jargs, traj, jtraj, adv, ret, key, perm, nbins,
     held) = TT.resumed_batch()
    env = types.SimpleNamespace(
        num_train_envs=TT.NTRAIN,
        curriculum_grid=types.SimpleNamespace(num_bins=nbins))
    _, jupdate = JP.make_train_functions(env, jac, jargs, TT.T)
    j1, jm = jax.jit(lambda s, k: jupdate(s, jtraj, adv, ret, k,
                                          entropy_coef=0.01))(
        jax.tree.map(jnp.asarray, jstate), key)
    tac, targs, ts = TT.port_state()
    lr0 = ts.lr
    _, tupdate = TP.make_train_functions(env, tac, targs, TT.T)
    ts, tm = tupdate(ts, *TT.torch_batch(traj, adv, ret),
                     TT.PermSampler(perm), entropy_coef=0.01)
    TT.check_update_matches_jax(((jstate, j1, jm), (lr0, ts, tm, tac),
                                 held))


def test_cpu_run_prints_bench_py_line(monkeypatch, capsys):
    bench = _load(BENCH)
    mod = _load(BENCH_CUDA)
    monkeypatch.setattr(TC, "config_mini_cheetah", small_cfg)
    size = mod._bench_size
    monkeypatch.setattr(mod, "_bench_size", lambda n, steps, **kw: size(
        n, 4, n_iter=1, **kw))
    figures = []
    emit = mod._emit
    monkeypatch.setattr(mod, "_emit", lambda v: (figures.append(v),
                                                 emit(v)))
    monkeypatch.setenv("BENCH_SIZES", "8")
    assert mod.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1 and len(figures) == 1, out
    assert figures[0] > 0
    bench._emit(figures[0])
    ref = capsys.readouterr().out
    assert json.loads(lines[0]) == json.loads(ref)
    assert lines[0] == ref.strip()
    assert "[bench] 8 envs: " in err and "env-steps/s (iter " in err
    assert re.search(r"1 timed iterations ms min [\d.]+ / median [\d.]+ / "
                     r"max [\d.]+; peak device memory not measured \(CPU\);"
                     r" K1 launches per iteration: none; the size took "
                     r"[\d.]+s in all", err), err
    assert "reporting 8-env figure" in err


@pytest.mark.parametrize("value", [0.4, 27.5, 48_636.49, 50_000.0,
                                   131_999.5])
def test_emit_matches_bench_py(capsys, value):
    _load(BENCH)._emit(value)
    ref = capsys.readouterr().out
    _load(BENCH_CUDA)._emit(value)
    assert capsys.readouterr().out == ref


def _env_reads(path):
    with open(path) as f:
        return dict(re.findall(r'os\.environ\.get\(\s*"(\w+)",\s*"([^"]*)"\)',
                               f.read()))


def test_environment_variables_match_bench_py():
    ref = _env_reads(BENCH)
    assert ref == {"BENCH_SIZES": "4000,1024,8192", "BENCH_BUDGET_S": "1500",
                   "BENCH_PALLAS": "1"}
    assert _env_reads(BENCH_CUDA) == ref


def test_exits_3_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    env = dict(os.environ, PYTHONPATH=RLTPU_ROOT_DIR)
    out = subprocess.run([sys.executable, BENCH_CUDA], cwd=RLTPU_ROOT_DIR,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 3, out.stderr
    assert out.stdout == ""
    assert "no CUDA card" in out.stderr
