"""The locomotion-capability gate on the port (scripts/torch_capability.py,
scripts/tune_trot_cuda.py) against the JAX package's
(tests/test_locomotion_capability.py, scripts/tune_trot.py).

Parity, on the CPU: the trot's action targets and the drift sweep's
batched ones equal JAX's to one ulp (the same float32 operations in the
same order; the port's sine, float64 rounded once, and XLA's float32 sine
differ by an ulp on ~1.3% of inputs in [0, 100]); 10 trot steps of 4 envs
from one converted initial state give JAX's per-env displacement, dones
and final height at the env tests' 2e-5 (the port's plain physics step agrees with JAX's to float rounding,
tests/test_torch_physics.py). The three gates themselves run at their own
sizes and thresholds, marked slow as JAX's are; chip_smoke.py runs them on
the card."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu import RLTPU_ROOT_DIR
from rapid_locomotion_rl_tpu.envs.legged_robot import LeggedRobotEnv as JEnv
from rapid_locomotion_rl_tpu_torch.convert import env_state_from_jax
from test_locomotion_capability import _clean_cfg

SCRIPTS = os.path.join(RLTPU_ROOT_DIR, "scripts")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name[:-3], os.path.join(SCRIPTS, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mods():
    import sys
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    return dict(jtrot=_script("tune_trot.py"),
                jsweep=_script("exp_drift_sweep.py"),
                trot=_script("tune_trot_cuda.py"),
                sweep=_script("exp_drift_sweep_cuda.py"),
                gate=_script("torch_capability.py"))


@pytest.fixture(scope="module")
def envs(mods):
    return JEnv(_clean_cfg(4)), mods["gate"]._env(mods["gate"].clean_cfg(4),
                                                  "cpu")


@pytest.mark.parametrize("i", [0, 7, 123])
def test_trot_actions_match_jax(mods, envs, i):
    jenv, tenv = envs
    jt = jnp.float32(i) * jenv.dt
    tt = mods["trot"].step_time(tenv, i)
    assert np.asarray(jt) == tt.numpy()
    p = (2.0, 0.8, 1.0, 0.5)
    np.testing.assert_array_max_ulp(
        mods["trot"].trot_actions(tenv, tt, torch.tensor(p)).numpy(),
        np.asarray(mods["jtrot"].trot_actions(jenv, jt, jnp.asarray(p))), 1)
    # four sweep points, negative thigh amplitudes among them
    P = mods["sweep"].sweep_params()
    np.testing.assert_array_equal(P, mods["jsweep"].sweep_params())
    P4 = P[[0, 13, 40, 71]]
    np.testing.assert_array_max_ulp(
        mods["trot"].trot_actions(tenv, tt, torch.tensor(P4)).numpy(),
        np.asarray(mods["jsweep"].trot_actions_batch(jenv, jt,
                                                     jnp.asarray(P4))), 1)


def test_run_trot_matches_jax(mods, envs):
    """10 steps of the trot at 4 envs from one converted initial state."""
    jenv, tenv = envs
    gate = mods["gate"]
    p = [gate.TROT[k] for k in ("freq", "a_thigh", "a_calf", "lead")]
    jstate = jenv.initial_state(jax.random.PRNGKey(0))
    jdx, jnd, jz = mods["jtrot"].make_runner(jenv, steps=10)(
        jstate, jnp.asarray(p, jnp.float32))
    tstate = env_state_from_jax(jax.tree.map(np.asarray, jstate),
                                device="cpu")
    dx, nd, z = mods["trot"].make_runner(tenv, steps=10)(
        tstate, torch.tensor(p))
    assert int(nd.sum()) == int(jnd)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(float(z.mean()), float(jz), rtol=2e-5,
                               atol=2e-5)


def test_gate_thresholds_are_jax_s(mods):
    """The gates' constants are the JAX test's, at the lines they cite."""
    gate = mods["gate"]
    src = open(os.path.join(RLTPU_ROOT_DIR, "tests",
                            "test_locomotion_capability.py")).read()
    lines = src.splitlines()
    assert "freq=2.0, a_thigh=0.8, a_calf=1.0, lead=0.5" in lines[74]
    assert gate.TROT == dict(freq=2.0, a_thigh=0.8, a_calf=1.0, lead=0.5)
    assert f"abs(dx) >= {gate.TROT_MIN_DX}" in lines[76]
    assert f"{gate.TROT_Z[0]} < z < {gate.TROT_Z[1]}" in lines[77]
    assert f"np.median(dx) >= {gate.FLAGSHIP_MIN_MEDIAN_DX}" in lines[109]
    assert f"[-4:].mean() > {gate.WALK_MIN_TOP4_SPEED}" in lines[161]
    import test_locomotion_capability as J
    assert os.path.relpath(gate.CKPT_R3, RLTPU_ROOT_DIR) == os.path.relpath(
        J.CKPT_R3 if os.path.isabs(J.CKPT_R3)
        else os.path.join(RLTPU_ROOT_DIR, J.CKPT_R3), RLTPU_ROOT_DIR)


# ---- the gates, at the JAX test's sizes and thresholds --------------------
@pytest.mark.slow
def test_scripted_trot_propels(mods):
    mods["gate"].gate_trot("cpu")


@pytest.mark.slow
def test_flagship_policy_tracks_forward(mods):
    if not os.path.exists(mods["gate"].CKPT_R3):
        pytest.skip("no flagship checkpoint present yet")
    mods["gate"].gate_flagship("cpu")


@pytest.mark.slow
def test_trained_policy_walks(mods):
    if not os.path.exists(mods["gate"].CKPT):
        pytest.skip("flagship checkpoint not present")
    mods["gate"].gate_walks("cpu")
