"""The port's Go1 env step against the JAX package's, from the same state.

The JAX side runs the SoA physics step under jax.disable_jit() (on the CPU
its "auto" setting would pick the vmapped AoS step, which agrees with SoA
only statistically). Observation noise is off. The two packages draw
different random numbers, which reach only envs that reset or resample
(pushes are off in config_go1, and DR re-randomization is 300 steps away),
so every comparison is over the envs that did not reset.

Tolerances: the physics agrees to float rounding (tests/test_torch_physics);
observations scale joint velocities by 0.05, and one env step chains 4
physics calls of 2 substeps, so values agree to atol 1e-4 / rtol 1e-4;
reward terms to atol 1e-6 (they are scaled by dt = 0.02)."""

import jax
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu import config as jcfg
from rapid_locomotion_rl_tpu.envs.legged_robot import LeggedRobotEnv as JEnv
from rapid_locomotion_rl_tpu_torch import config as tcfg
from rapid_locomotion_rl_tpu_torch.convert import env_state_from_jax
from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
from rapid_locomotion_rl_tpu_torch.sampler import Sampler

N = 16


def _cfgs(decimation=4):
    out = []
    for mod in (jcfg, tcfg):
        c = mod.config_go1()
        c.env.num_envs = N
        c.sim.physics_impl = "soa"
        c.noise.add_noise = False
        c.control.decimation = decimation
        out.append(c)
    return out


def _actions(seed):
    return np.random.default_rng(seed).normal(0, 0.5, (N, 12)).astype(
        np.float32)


def _step_both(jenv, tenv, jstate, tstate, seed):
    a = _actions(seed)
    with jax.disable_jit():
        jnew, jres = jenv.step(jstate, jax.numpy.asarray(a))
        jterms = jenv.reward_terms(jnew)
    tnew, tres = tenv.step(tstate, torch.tensor(a), Sampler(seed, "cpu"))
    tterms = tenv.reward_terms(tnew)
    return (jnew, jres, jterms), (tnew, tres, tterms)


def lower(jstate, z=0.29):
    """The initial state with the bases lowered so that the feet start in
    contact: the step then runs the contact solve and the contact-driven
    terms (air time, collisions, termination)."""
    pos = np.asarray(jstate.sim.base_pos).copy()
    pos[:, 2] = z
    return jstate._replace(sim=jstate.sim._replace(
        base_pos=jax.numpy.asarray(pos)))


@pytest.fixture(scope="module")
def one_step():
    """Go1, 16 envs, decimation 4: a JAX initial state converted to torch,
    then one env step in each package."""
    jc, tc = _cfgs()
    jenv, tenv = JEnv(jc), LeggedRobotEnv(tc, device="cpu")
    with jax.disable_jit():
        jstate = lower(jenv.initial_state(jax.random.PRNGKey(0)))
    tstate = env_state_from_jax(jax.tree.map(np.asarray, jstate),
                                device="cpu")
    return _step_both(jenv, tenv, jstate, tstate, 1)


@pytest.fixture(scope="module")
def more_steps(one_step):
    """Two more steps from there, at decimation 1 (each JAX step runs the
    eager SoA physics ~9 s per call on this CPU)."""
    jc, tc = _cfgs(decimation=1)
    jenv, tenv = JEnv(jc), LeggedRobotEnv(tc, device="cpu")
    (jstate, _, _), (tstate, _, _) = one_step
    jdone = np.zeros(N, bool)
    for seed in (2, 3):
        (jstate, jres, jterms), (tstate, tres, tterms) = _step_both(
            jenv, tenv, jstate, tstate, seed)
        jdone |= np.asarray(jres.done) | tres.done.numpy()
    return (jstate, jres, jterms), (tstate, tres, tterms), jdone


def _kept(j, t, done=None):
    (_, jres, _), (_, tres, _) = j, t
    d = np.asarray(jres.done) | tres.done.numpy()
    if done is not None:
        d = d | done
    keep = ~d
    assert keep.sum() >= N // 2, "too few envs kept to compare"
    return keep


@pytest.fixture(params=["one", "more"])
def case(request, one_step):
    if request.param == "one":
        j, t = one_step
        return j, t, _kept(j, t)
    j, t, done = request.getfixturevalue("more_steps")
    return j, t, _kept(j, t, done)


@pytest.mark.parametrize("field", ["obs", "privileged_obs", "obs_history",
                                   "rew"])
def test_step_outputs_match(case, field):
    (_, jres, _), (_, tres, _), keep = case
    np.testing.assert_allclose(getattr(tres, field).numpy()[keep],
                               np.asarray(getattr(jres, field))[keep],
                               rtol=1e-4, atol=1e-4)


def test_dones_and_time_outs_match(case):
    (_, jres, _), (_, tres, _), keep = case
    np.testing.assert_array_equal(tres.done.numpy(), np.asarray(jres.done))
    np.testing.assert_array_equal(tres.info["time_outs"].numpy(),
                                  np.asarray(jres.info["time_outs"]))


def test_reward_terms_match(case):
    (_, _, jterms), (_, _, tterms), keep = case
    assert set(jterms) == set(tterms)
    for name in jterms:
        np.testing.assert_allclose(tterms[name].numpy()[keep],
                                   np.asarray(jterms[name])[keep],
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_sim_state_matches(case):
    (jnew, _, _), (tnew, _, _), keep = case
    assert np.abs(np.asarray(jnew.contact_report)).max() > 1.0, \
        "the feet should be in contact"
    for name in ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
                 "q", "qd"):
        np.testing.assert_allclose(
            getattr(tnew.sim, name).numpy()[keep],
            np.asarray(getattr(jnew.sim, name))[keep],
            rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(tnew.contact_report.numpy()[keep],
                               np.asarray(jnew.contact_report)[keep],
                               rtol=1e-3, atol=1e-2)


def test_reset_envs_matches_jax(one_step):
    """Masked explicit reset from the post-step state. Go1 resets to the
    exact default pose at rest (dof_init_range [1, 1], no root-velocity
    draw), so the sim state matches exactly; the DR draws differ between
    the packages, so masked envs are checked against their ranges and the
    others for being unchanged."""
    jc, tc = _cfgs()
    jenv, tenv = JEnv(jc), LeggedRobotEnv(tc, device="cpu")
    (jstate, _, _), (tstate, _, _) = one_step
    mask = np.arange(N) % 2 == 0
    with jax.disable_jit():
        jr = jenv.reset_envs(jstate, jax.numpy.asarray(mask))
    tr = tenv.reset_envs(tstate, torch.tensor(mask), Sampler(5, "cpu"))
    for name in ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
                 "q", "qd"):
        np.testing.assert_allclose(getattr(tr.sim, name).numpy(),
                                   np.asarray(getattr(jr.sim, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for name in ("episode_length", "last_actions", "last_dof_vel",
                 "feet_air_time"):
        np.testing.assert_allclose(getattr(tr, name).numpy(),
                                   np.asarray(getattr(jr, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for k in jr.episode_sums:
        np.testing.assert_allclose(tr.episode_sums[k].numpy(),
                                   np.asarray(jr.episode_sums[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    dr = tc.domain_rand
    lo, hi = dr.friction_range
    f = tr.dr.friction.numpy()
    assert ((f[mask] >= lo) & (f[mask] <= hi)).all()
    np.testing.assert_array_equal(f[~mask], tstate.dr.friction.numpy()[~mask])
    lo, hi = dr.added_mass_range
    p = tr.dr.payloads.numpy()
    assert ((p[mask] >= lo) & (p[mask] <= hi)).all()
    np.testing.assert_array_equal(p[~mask], tstate.dr.payloads.numpy()[~mask])
