"""The port's evaluation path against the JAX package's: the metric probes,
the DR presets, the debug helpers, the student-policy export and the four
entry scripts (play, the eval sweep, the smoke test, HLP play).

- Every ``METRICS_FNS`` probe on one state, converted from a JAX env step
  (Mini Cheetah on the plane, 8 envs, feet in contact, decimation 1),
  with the runs/r4_flagship_4000 params converted, against the JAX
  probe at rtol 1e-5 / atol 1e-6; the registry's names and order as in
  tests/test_aux.py.
- The six ``DR_SETTINGS`` on both packages' ``config_mini_cheetah`` give
  equal ``to_dict()``.
- ``state_health``, ``nan_env_mask`` and ``checked_step`` on a state
  with one NaN env.
- The ``.pt2`` export of the student policy reloads to the same actions.
- Each script's flags are its JAX script's plus ``--device`` (default
  cuda); each raises without a card unless ``--device cpu``; each runs on
  the CPU on a few envs for 2-3 steps from runs/r4_flagship_4000 (and
  runs/r5_hlp7 for HLP play); the 1- and 3-env envs take the column-block
  window of the 3 x 3-cell terrain.
- The chip sweep of runs/r4_flagship_4000
  (runs/port_eval_r4_flagship_4000/eval_sweep.json) lies in the band
  around the JAX sweep (runs/r4_flagship_4000/eval_sweep.json) fixed
  before the chip run; the band's numbers are the constants below."""

import argparse
import importlib.util
import json
import os
import runpy
import shutil

import jax
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu import RLTPU_ROOT_DIR
from rapid_locomotion_rl_tpu import config as jcfg
from rapid_locomotion_rl_tpu.envs.legged_robot import LeggedRobotEnv as JEnv
from rapid_locomotion_rl_tpu.learn import metrics as JM
from rapid_locomotion_rl_tpu.learn.dr_eval import DR_SETTINGS as JDR
from rapid_locomotion_rl_tpu.models import networks as JN
from rapid_locomotion_rl_tpu.utils.checkpoint import load_pytree as jload
from rapid_locomotion_rl_tpu_torch import config as tcfg
from rapid_locomotion_rl_tpu_torch.convert import (env_state_from_jax,
                                                   params_from_flax)
from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
from rapid_locomotion_rl_tpu_torch.learn import metrics as TM
from rapid_locomotion_rl_tpu_torch.learn.dr_eval import DR_SETTINGS
from rapid_locomotion_rl_tpu_torch.models import networks as TN
from rapid_locomotion_rl_tpu_torch.sampler import Sampler
from rapid_locomotion_rl_tpu_torch.utils import debug
from rapid_locomotion_rl_tpu_torch.utils.checkpoint import \
    export_student_policy

LL_RUN = os.path.join(RLTPU_ROOT_DIR, "runs", "r4_flagship_4000")
HLP_RUN = os.path.join(RLTPU_ROOT_DIR, "runs", "r5_hlp7")
JAX_SWEEP = os.path.join(LL_RUN, "eval_sweep.json")
PORT_SWEEP = os.path.join(RLTPU_ROOT_DIR, "runs", "port_eval_r4_flagship_4000",
                          "eval_sweep.json")
N = 8

# the band of the chip sweep around the JAX sweep, per preset
MAX_DONE_RATE = 0.01
BASE_HEIGHT_ATOL = 0.02          # m
CONTACT_RATE_ATOL = 0.10
VEL_RMSD_RATIO, VEL_RMSD_SLACK = 1.5, 0.05
COT_RATIO_RANGE = (0.67, 1.5)
ADAPTATION_LOSS_RATIO = 2.0


@pytest.fixture(scope="module")
def probe_state():
    """One JAX env step (SoA physics, eager) from the initial state with
    the bases lowered into contact, and the same state in the port."""
    cfgs = []
    for mod in (jcfg, tcfg):
        c = mod.config_mini_cheetah()
        c.env.num_envs = N
        c.terrain.mesh_type = "plane"
        c.terrain.teleport_robots = False
        c.control.decimation = 1
        c.sim.physics_impl = "soa"
        c.noise.add_noise = False
        cfgs.append(c)
    jenv, tenv = JEnv(cfgs[0]), LeggedRobotEnv(cfgs[1], device="cpu")
    actions = np.random.default_rng(1).normal(0, 0.5, (N, 12))
    with jax.disable_jit():
        s = jenv.initial_state(jax.random.PRNGKey(0))
        pos = np.asarray(s.sim.base_pos).copy()
        pos[:, 2] = 0.28
        s = s._replace(sim=s.sim._replace(base_pos=jax.numpy.asarray(pos)))
        s, _ = jenv.step(s, jax.numpy.asarray(actions, np.float32))
    tstate = env_state_from_jax(jax.tree.map(np.asarray, s), device="cpu")
    params = jload(os.path.join(LL_RUN, "checkpoints",
                                "train_state_last.pkl"))["ppo_state"].params
    dims = (jenv.num_obs, jenv.num_privileged_obs, jenv.num_obs_history,
            jenv.num_actions)
    jac = JN.ActorCritic(*dims, JN.ACArgs())
    tac = TN.ActorCritic(*dims, TN.ACArgs())
    tac.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, params)["params"]))
    return (jenv, s, jac, params), (tenv, tstate, tac)


def test_registry_names_match_jax():
    assert list(TM.METRICS_FNS) == list(JM.METRICS_FNS)
    for ref_name in ("lin_vel_rmsd", "ang_vel_rmsd", "lin_vel_x",
                     "ang_vel_yaw", "max_torques", "power_consumption",
                     "cost_of_transport", "froude_number",
                     "adaptation_loss", "auxiliary_rewards", "termination",
                     "privileged_obs", "latents", "base_height"):
        assert ref_name in TM.METRICS_FNS, ref_name


@pytest.mark.parametrize("name", list(JM.METRICS_FNS))
def test_probe_matches_jax(probe_state, name):
    (jenv, jstate, jac, params), (tenv, tstate, tac) = probe_state
    assert np.abs(np.asarray(jstate.contact_report)).max() > 1.0
    ref = JM.METRICS_FNS[name](jenv, jstate, jac, params)
    got = TM.METRICS_FNS[name](tenv, tstate, tac, None)
    if isinstance(ref, dict):
        assert set(got) == set(ref) == set(tenv.reward_names)
        pairs = [(k, got[k], ref[k]) for k in ref]
    else:
        pairs = [(name, got, ref)]
    for k, a, b in pairs:
        assert tuple(a.shape) == np.shape(b), k
        assert torch.isfinite(a).all(), k
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", list(JDR))
def test_dr_settings_match_jax(name):
    assert list(DR_SETTINGS) == list(JDR)
    base = tcfg.config_mini_cheetah()
    got = DR_SETTINGS[name](base)
    assert got is not base
    assert got.to_dict() == JDR[name](jcfg.config_mini_cheetah()).to_dict()


def test_state_health_and_nan_env_mask(probe_state):
    _, (tenv, tstate, _) = probe_state
    h = debug.state_health(tstate)
    assert bool(h["sim/finite"]) and bool(h["episode_sums/finite"])
    assert float(h["sim/max_abs"]) > 0.0
    assert not debug.nan_env_mask(tstate).any()
    q = tstate.sim.q.clone()
    q[3, 5] = float("nan")
    bad = tstate._replace(sim=tstate.sim._replace(q=q))
    mask = debug.nan_env_mask(bad)
    assert mask.tolist() == [i == 3 for i in range(N)]
    h = debug.state_health(bad)
    assert not bool(h["sim/finite"]) and bool(h["obs/finite"])


def test_checked_step_flags(probe_state):
    _, (tenv, tstate, _) = probe_state
    step = debug.checked_step(tenv)
    a = torch.zeros((N, tenv.num_actions))
    errors, (s, res) = step(tstate, a, Sampler(0, "cpu"))
    assert "state/sim/q" in errors and "result/rew" in errors
    assert all(bool(v) for v in errors.values())
    q = tstate.sim.q.clone()
    q[2] = float("nan")
    errors, _ = step(tstate._replace(sim=tstate.sim._replace(q=q)), a,
                     Sampler(0, "cpu"))
    assert not bool(errors["state/sim/q"]) and not bool(errors["result/rew"])


@pytest.mark.parametrize("use_latent", [True, False],
                         ids=["student", "hlp"])
def test_student_export_round_trip(tmp_path, use_latent):
    dims = (42, 18, 630, 12) if use_latent else (14, 18, 16, 3)
    args = TN.ACArgs(use_latent=use_latent,
                     activation="elu" if use_latent else "tanh")
    ac = TN.ActorCritic(*dims, args)
    prefix = str(tmp_path / "student_policy_latest")
    export_student_policy(ac, {"params": {}}, dims[0], dims[2], prefix)
    assert os.path.exists(prefix + ".params.pkl")
    program = torch.export.load(prefix + ".pt2").module()
    rng = np.random.default_rng(0)
    obs = torch.tensor(rng.normal(size=(1, dims[0])), dtype=torch.float32)
    hist = torch.tensor(rng.normal(size=(1, dims[2])), dtype=torch.float32)
    with torch.no_grad():
        assert torch.equal(program(obs, hist), ac.act_student(obs, hist))


# ---------------------------------------------------------------------------
# the entry scripts

def _script(name):
    path = os.path.join(RLTPU_ROOT_DIR, "scripts", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def _flags(monkeypatch, call):
    """The flags of the ArgumentParser that ``call`` builds, caught at
    parse_args."""
    seen = {}

    def grab(self, *a, **k):
        seen["p"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        call()
    return {a.option_strings[-1]: (type(a).__name__, a.default, a.type,
                                   a.choices, a.nargs, a.const, a.required)
            for a in seen["p"]._actions if a.option_strings[-1] != "--help"}


def _jax_main(name):
    """scripts/<name> run as __main__ (the scripts whose parser is built
    there) or its main()."""
    path = os.path.join(RLTPU_ROOT_DIR, "scripts", name)
    if name == "play.py":
        return lambda: runpy.run_path(path, run_name="__main__")
    return _script(name).main


SCRIPTS = [("play_cuda.py", "play.py"),
           ("eval_sweep_cuda.py", "eval_sweep.py"),
           ("test_cuda.py", "test.py"), ("hlp_play_cuda.py", "hlp_play.py")]


@pytest.mark.parametrize("port,ref", SCRIPTS, ids=[s[1] for s in SCRIPTS])
def test_flags_match_jax_script(monkeypatch, port, ref):
    got = _flags(monkeypatch, _script(port).parse_args)
    # scripts/test.py takes no flags
    want = ({} if ref == "test.py"
            else _flags(monkeypatch, _jax_main(ref)))
    assert set(got) - set(want) == {"--device"}
    assert got["--device"][1] == "cuda"
    for flag in want:
        assert got[flag] == want[flag], flag


def _call_without_card(port):
    mod = _script(port)
    if port == "play_cuda.py":
        return lambda: mod.load_env(LL_RUN)
    if port == "eval_sweep_cuda.py":
        return lambda: mod.evaluate(LL_RUN, "static_low",
                                    DR_SETTINGS["static_low"], 2, 1)
    if port == "test_cuda.py":
        return lambda: mod.run_env(2, 1)
    return lambda: mod.main(["--hlp-run", HLP_RUN, "--ll-run", LL_RUN])


@pytest.mark.parametrize("port", [s[0] for s in SCRIPTS])
def test_raises_without_a_card(port):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="--device cpu"):
        _call_without_card(port)()


def _run_copy(tmp_path):
    """A run directory holding runs/r4_flagship_4000's parameters.json and
    a link to its train state, so that what a script writes beside the
    run lands in ``tmp_path``."""
    d = tmp_path / "run"
    (d / "checkpoints").mkdir(parents=True)
    shutil.copy(os.path.join(LL_RUN, "parameters.json"), d)
    os.symlink(os.path.join(LL_RUN, "checkpoints", "train_state_last.pkl"),
               d / "checkpoints" / "train_state_last.pkl")
    return d


def test_play_cpu(tmp_path):
    run = _run_copy(tmp_path)
    gif = tmp_path / "play.gif"
    r = _script("play_cuda.py").main(["--logdir", str(run), "--steps", "3",
                                      "--gif", str(gif), "--device", "cpu"])
    env = r["env"]
    assert env.num_envs == 1 and env.num_train_envs == 1
    assert env.cfg.terrain.mesh_type == "trimesh"
    assert r["vx"].shape == r["z"].shape == r["done"].shape == (3,)
    assert np.isfinite(r["mean_vx"]) and not r["done"].any()
    assert ((0.15 < r["height"]) & (r["height"] < 0.5)).all()
    assert (run / "play.png").exists()
    assert r["gif"] == str(gif) and gif.stat().st_size > 2_000


@pytest.mark.parametrize("num_envs", [1, 3])
def test_small_envs_take_the_column_block_window(num_envs):
    from rapid_locomotion_rl_tpu_torch.ops.contact import blocked_window
    env, _ = _script("play_cuda.py").load_env(LL_RUN, num_envs=num_envs,
                                              device="cpu")
    rows, cols = env.collision_grid.height.shape
    assert rows >= 32 and cols >= 128
    assert env._window is blocked_window
    s = env.initial_state(Sampler(0, "cpu"))
    w = env._window(env.collision_grid, s.sim.base_pos[:, 0],
                    s.sim.base_pos[:, 1])
    assert w.ix0.shape == (num_envs,)
    assert ((w.ix0 >= 0) & (w.ix0 + w.rows <= rows)).all()
    assert ((w.iy0 >= 0) & (w.iy0 + w.cols <= cols)).all()


def test_eval_sweep_cpu(tmp_path):
    run = _run_copy(tmp_path)
    res = _script("eval_sweep_cuda.py").main([
        "--logdir", str(run), "--num-envs", "4", "--steps", "2",
        "--presets", "static_medium", "--device", "cpu"])
    with open(run / "eval_sweep_cuda.json") as f:
        assert json.load(f) == res
    row = res["static_medium"]
    for name in TM.METRICS_FNS:
        if name == "auxiliary_rewards":
            assert any(k.startswith(name + "/") for k in row)
        else:
            assert name in row, name
    for k, v in row.items():
        assert np.isfinite(v).all(), k
    assert np.shape(row["latents"]) == (18,)
    assert row["done_rate"] == 0.0


def test_smoke_test_cpu():
    env, state, rows = _script("test_cuda.py").run_env(3, 2, device="cpu")
    assert env.num_envs == 3 and env._window is not None
    assert [r[0] for r in rows] == [0]
    assert np.isfinite(rows[0][1]) and 0.15 < rows[0][2] < 0.5
    assert torch.isfinite(state.sim.base_pos).all()


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["deterministic", "stochastic"])
def test_hlp_play_cpu(tmp_path, stochastic):
    gif = tmp_path / "nav.gif"
    argv = ["--hlp-run", HLP_RUN, "--ll-run", LL_RUN, "--num-envs", "4",
            "--steps", "3", "--gif", str(gif), "--device", "cpu"]
    r = _script("hlp_play_cuda.py").main(
        argv + (["--stochastic"] if stochastic else []))
    assert r["env"].num_envs == 4 and r["env"].ll_env.num_envs == 4
    assert r["min_dist"].shape == (4,) and np.isfinite(r["min_dist"]).all()
    assert r["falls"] == max(0, r["episodes"] - r["goals"] - r["timeouts"])
    assert torch.isfinite(r["state"].ll.sim.base_pos).all()
    assert r["gif"] == str(gif) and gif.stat().st_size > 2_000


# ---------------------------------------------------------------------------
def test_chip_sweep_in_band_of_jax():
    with open(JAX_SWEEP) as f:
        ref = json.load(f)
    with open(PORT_SWEEP) as f:
        got = json.load(f)
    assert set(got) == set(ref) == set(DR_SETTINGS)
    for name, r in ref.items():
        g = got[name]
        assert g["done_rate"] <= MAX_DONE_RATE, name
        assert abs(g["base_height"] - r["base_height"]) <= \
            BASE_HEIGHT_ATOL, name
        assert abs(g["contact_rate"] - r["contact_rate"]) <= \
            CONTACT_RATE_ATOL, name
        for k in ("lin_vel_rmsd", "ang_vel_rmsd"):
            assert g[k] <= VEL_RMSD_RATIO * r[k] + VEL_RMSD_SLACK, (name, k)
        lo, hi = COT_RATIO_RANGE
        assert lo * r["cost_of_transport"] <= g["cost_of_transport"] <= \
            hi * r["cost_of_transport"], name
        assert g["adaptation_loss"] <= \
            ADAPTATION_LOSS_RATIO * r["adaptation_loss"], name
