"""The port's research and diagnostic scripts (scripts/*_cuda.py) against
the JAX package's (scripts/*.py), on the CPU at small sizes.

- The twins of the JAX scripts that take flags take the same flags with
  the same defaults, plus ``--device`` (defaulting to ``cuda``).
- diag_survival: one step of 8 envs from a converted JAX state with forced
  terminations (time-outs, bases on the ground upside down); the per-env
  outputs and the printed cause breakdown equal JAX's.
- sim2sim: the loader maps one synthetic rsl_rl state dict to the port's
  ActorCritic with every parameter equal to the tree of JAX's loader, bit
  for bit; the student and teacher actions then agree at
  tests/test_torch_policy.py's rtol 1e-4 / atol 1e-5 (float32 matrix
  products accumulate in another order in XLA and PyTorch: ~2e-6 apart
  through the 630-input adaptation module).
- diag_hlp: the scripted controllers' commands equal JAX's, exactly (JAX's
  controller is taken out of its ``main``).
- run_peek.py and compare_baseline.py (no JAX, used unedited) read the
  metrics.jsonl and curriculum/info.pkl that the port's Runner writes, on
  a 2-iteration CPU run of scripts/exp_tracking_only_cuda.py.
"""

import argparse
import contextlib
import importlib.util
import io
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu import RLTPU_ROOT_DIR

SCRIPTS = os.path.join(RLTPU_ROOT_DIR, "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name[:-3], os.path.join(SCRIPTS, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def _flags(monkeypatch, call):
    """{flag: (action, default, type, choices, nargs, const)} of the
    ArgumentParser that ``call`` builds, caught at parse_args."""
    seen = {}

    def grab(self, *a, **k):
        seen["p"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        call()
    monkeypatch.undo()
    return {a.option_strings[-1]: (type(a).__name__, a.default, a.type,
                                   a.choices, a.nargs, a.const)
            for a in seen["p"]._actions if a.option_strings[-1] != "--help"}


# the only defaults that differ, and why: JAX's trace goes to /tmp, the
# port writes nothing outside its checkout
DIFFERENT = {("profile_rollout.py", "--trace-dir"): "build/torch-trace"}


@pytest.mark.parametrize("name", ["diag_survival.py", "diag_hlp.py",
                                  "diag_hlp_rollout.py", "bench_terrain.py",
                                  "profile_rollout.py"])
def test_flags_match_jax_scripts(monkeypatch, name):
    ref = _flags(monkeypatch, _script(name).main)
    got = _flags(monkeypatch, _script(name[:-3] + "_cuda.py").parse_args)
    assert set(got) - set(ref) == {"--device"}
    assert set(ref) - set(got) == set()
    assert got["--device"][1] == "cuda"
    for flag in ref:
        want = ref[flag]
        if (name, flag) in DIFFERENT:
            want = want[:1] + (DIFFERENT[name, flag],) + want[2:]
        assert got[flag] == want, flag


def test_twins_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    mod = _script("diag_survival_cuda.py")
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.build_env(4, True, True)


# ---- diag_survival ---------------------------------------------------------
def test_survival_breakdown_matches_jax():
    from rapid_locomotion_rl_tpu.config import config_mini_cheetah as jcfg
    from rapid_locomotion_rl_tpu.envs.legged_robot import \
        LeggedRobotEnv as JEnv
    from rapid_locomotion_rl_tpu_torch.convert import env_state_from_jax
    jmod, tmod = _script("diag_survival.py"), _script("diag_survival_cuda.py")
    n = 8
    c = jcfg()
    c.env.num_envs = n
    c.terrain.mesh_type = "plane"
    c.terrain.teleport_robots = False
    c.rewards.use_terminal_body_height = True
    jenv = JEnv(c)
    tenv, tc = tmod.build_env(n, True, False, "cpu")
    tc.rewards.use_terminal_body_height = True

    s = jax.tree.map(np.asarray, jenv.initial_state(jax.random.PRNGKey(0)))
    ep = s.episode_length.copy()
    ep[:2] = jenv.derived.max_episode_length         # envs 0-1 time out
    pos, quat = s.sim.base_pos.copy(), s.sim.base_quat.copy()
    pos[2:5, 2] = 0.05                                # 2-4 upside down on
    quat[2:5] = (1.0, 0.0, 0.0, 0.0)                  # the ground (xyzw)
    pos[5, 2] = 0.12                                  # 5 low, upright
    s = s._replace(episode_length=ep,
                   sim=s.sim._replace(base_pos=pos, base_quat=quat))
    jstate = jax.tree.map(jnp.asarray, s)
    jenv.initial_state = lambda key: jstate
    jout = jmod.run(jenv, 1, action_std=0.0, seed=0)
    tout, _ = tmod.run(tenv, 1, action_std=0.0, seed=0,
                       state=env_state_from_jax(s, device="cpu"))
    assert set(tout) == set(jout)
    assert jout["done"][0, :2].all() and jout["done"][0, 2:5].all()
    for k in ("done", "timeout", "ep_len", "term_body", "height_term"):
        np.testing.assert_array_equal(tout[k], jout[k], err_msg=k)
    np.testing.assert_allclose(tout["base_z"], jout["base_z"], rtol=2e-5,
                               atol=2e-5)
    printed = []
    for mod, env, out in ((jmod, jenv, jout), (tmod, tenv, tout)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.summarize(env, out, "forced")
        printed.append(buf.getvalue())
    assert "cause: timeout 2, contact-term" in printed[0]
    assert printed[1] == printed[0]


# ---- sim2sim's loader -------------------------------------------------------
def test_sim2sim_loader_matches_jax(tmp_path):
    from rapid_locomotion_rl_tpu.models.networks import ACArgs as JArgs
    from rapid_locomotion_rl_tpu.models.networks import \
        ActorCritic as JAC
    from rapid_locomotion_rl_tpu_torch.models.networks import (ACArgs,
                                                               ActorCritic)
    n_obs, n_priv, n_hist, n_act = 42, 18, 630, 12
    rng = np.random.default_rng(0)
    ac = ActorCritic(n_obs, n_priv, n_hist, n_act, ACArgs())
    # rsl_rl's layout: Linear i of each MLP at Sequential entry 2 i
    sd = {}
    for k, v in ac.state_dict().items():
        x = torch.tensor(rng.normal(0, 0.1, tuple(v.shape)), dtype=v.dtype)
        if k == "std":
            sd[k] = x.abs() + 0.5
            continue
        prefix, _, i, leaf = k.split(".")
        sd[f"{prefix}.{2 * int(i)}.{leaf}"] = x
    path = str(tmp_path / "ac_weights_last.pt")
    torch.save(sd, path)

    jparams = _script("sim2sim.py").load_reference_params(path)
    ac.load_state_dict(_script("sim2sim_cuda.py").load_reference_params(path))
    # every parameter equals JAX's, bit for bit (a Flax kernel is the
    # transposed Linear weight)
    jflat = {"std": jparams["params"]["std"]}
    for prefix, layers in jparams["params"].items():
        if prefix != "std":
            for dense, leaves in layers.items():
                i = int(dense.split("_")[1])
                jflat[f"{prefix}.layers.{i}.weight"] = leaves["kernel"].T
                jflat[f"{prefix}.layers.{i}.bias"] = leaves["bias"]
    got = ac.state_dict()
    assert set(got) == set(jflat)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jflat[k]),
                                      err_msg=k)
    jac = JAC(n_obs, n_priv, n_hist, n_act, JArgs())
    obs = rng.normal(0, 1, (8, n_obs)).astype(np.float32)
    priv = rng.normal(0, 1, (8, n_priv)).astype(np.float32)
    hist = rng.normal(0, 1, (8, n_hist)).astype(np.float32)
    with torch.no_grad():
        for method, other in (("act_student", hist), ("act_teacher", priv)):
            want = jac.apply(jparams, obs, other,
                             method=getattr(JAC, method))
            got = getattr(ac, method)(torch.tensor(obs), torch.tensor(other))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-5, err_msg=method)


# ---- diag_hlp's controllers --------------------------------------------------
def _jax_controller(vx):
    """JAX diag_hlp.py's controller, taken out of its ``main`` with its
    closure (``args`` for --vx, ``jnp``)."""
    main = _script("diag_hlp.py").main
    code = next(c for c in main.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "controller")
    cells = {"args": argparse.Namespace(vx=vx), "jnp": jnp}
    return types.FunctionType(code, main.__globals__, "controller", None,
                              tuple(types.CellType(cells[n])
                                    for n in code.co_freevars))


@pytest.mark.parametrize("vx", [1.0, 0.6])
def test_diag_hlp_controllers_match_jax(vx):
    mod = _script("diag_hlp_cuda.py")
    ctrl = _jax_controller(vx)
    rng = np.random.default_rng(1)
    obs = rng.normal(0, 2, (256, 14)).astype(np.float32)
    obs[:, 12:14] = (3.0, 0.0)                          # the goal
    obs[:8, 0:2] = obs[:8, 12:14] + rng.normal(0, 0.05, (8, 2))  # near it
    obs[8:16, 0:2] = (3.0, 0.0)                         # on it
    for arm in ("zero", "straight", "pcontrol"):
        np.testing.assert_array_equal(
            mod.controller(arm, torch.tensor(obs), vx).numpy(),
            np.asarray(ctrl(arm, jnp.asarray(obs))), err_msg=arm)


# ---- run_peek.py and compare_baseline.py on a run of the port ---------------
def test_run_tools_read_a_port_run(tmp_path):
    mod = _script("exp_tracking_only_cuda.py")
    cfg = mod.tracking_only_cfg(16)
    # the general step: the CPU's quickest path; this test reads the logs
    cfg.sim.physics_impl = "aos"
    logdir = str(tmp_path / "run")
    mod.run(2, 0.0, logdir, device="cpu", cfg=cfg)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = {}
    for tool in ("run_peek.py", "compare_baseline.py"):
        r = subprocess.run([sys.executable, os.path.join(SCRIPTS, tool),
                            logdir], capture_output=True, text=True,
                           timeout=120, env=env)
        assert r.returncode == 0, r.stderr
        out[tool] = r.stdout
    peek = out["run_peek.py"].splitlines()
    assert peek[0].startswith("it     0  rew_total="), peek
    for ch in ("rew_tracking_lin_vel", "rew_tracking_ang_vel",
               "command_area", "time_iter"):
        assert f" {ch}=" in peek[0], ch
    assert any(x.startswith("curriculum @ it 0: mean_vx=") for x in peek)
    assert "area=0.0058" in out["run_peek.py"]
    for ch in ("rew_total", "rew_tracking_lin_vel", "rew_tracking_ang_vel",
               "command_area"):
        assert f"\n{ch}:\n  iter      ours       ref      ratio" in \
            out["compare_baseline.py"], ch
