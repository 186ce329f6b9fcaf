"""The port's env with the general (AoS) physics held to the golden
trajectory of tests/test_golden.py (tests/golden_smoke.json, written by the
JAX env on the CPU, where its ``auto`` picks AoS): config_mini_cheetah at
64 envs on 2 x 2 trimesh cells, zero actions, 50 steps; per step the sums
of the rewards, base positions, joint angles and dones, at that test's
rtol 2e-4 / atol 2e-3.

The port draws through a Sampler, so every draw of that run is replayed
from JAX's own keys: the initial state is JAX's (key 1234), converted; at
every step the sampler takes the step's 7-way split of the env key, as the
JAX env's step does, and hands each named stream the JAX draw it stands
for (pushes, DOF and rigid-body DR, command resampling with the bins drawn
from the port's curriculum weights, terrain levels, the reset spawn,
observation noise)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu_torch.convert import env_state_from_jax
from rapid_locomotion_rl_tpu_torch.sampler import Sampler

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_smoke.json")
NUM_ENVS, STEPS = 64, 50


def _cfg(mod):
    """tests/test_golden.py::_run's configuration."""
    cfg = mod.config_mini_cheetah()
    cfg.env.num_envs = NUM_ENVS
    cfg.terrain.num_rows = 2
    cfg.terrain.num_cols = 2
    cfg.terrain.border_size = 5.0
    return cfg


class JaxKeySampler(Sampler):
    """Each named stream of the port's step as the JAX env's step draws it
    from the step's key (``set_key`` before every step)."""

    def __init__(self):
        super().__init__(0, "cpu")
        self.draws = {}

    def set_key(self, key):
        (_, k_push, k_dof, k_resample, k_reset, k_noise,
         k_terrain) = jax.random.split(key, 7)
        self.k_noise, self.k_terrain = k_noise, k_terrain
        self.k_resample = k_resample
        self.draws = {}
        self._dof("dof_props", k_dof)
        self.draws["push"] = k_push
        k_r1, k_r2, k_r3 = jax.random.split(k_reset, 3)
        self._dof("reset_dof_props", k_r1)
        k = jax.random.split(k_r2, 4)
        for name, kk in zip(("friction", "restitution", "payload", "com"),
                            k):
            self.draws[f"reset_rigid_props/{name}"] = kk
        k1, k2, k3 = jax.random.split(k_r3, 3)
        self.draws.update({"reset_sim/x_init": k1,
                           "reset_sim/y_init": jax.random.fold_in(k1, 1),
                           "reset_sim/dof": k2, "reset_sim/root_vel": k3,
                           "noise": k_noise,
                           "resample/cell": jax.random.split(k_resample)[1]})

    def _dof(self, stream, key):
        for name, kk in zip(("motor", "kp", "kd"), jax.random.split(key, 3)):
            self.draws[f"{stream}/{name}"] = kk

    def uniform(self, name, shape, lo, hi):
        u = jax.random.uniform(self.draws[name], tuple(shape), minval=lo,
                               maxval=hi)
        return torch.tensor(np.asarray(u))

    def integers(self, name, shape, lo, hi):
        assert name == "terrain/levels", name
        return torch.tensor(np.asarray(jax.random.randint(
            self.k_terrain, tuple(shape), lo, hi)))

    def categorical(self, name, weights, n):
        assert name == "resample/bins", name
        w = jnp.asarray(weights.numpy())
        logits = jnp.where(w > 0, jnp.log(w + 1e-12), -jnp.inf)
        kb = jax.random.split(self.k_resample)[0]
        return torch.tensor(np.asarray(jax.random.categorical(
            kb, logits, shape=(n,)))).long()


@pytest.fixture(scope="module")
def port_sums():
    from rapid_locomotion_rl_tpu import config as jcfg
    from rapid_locomotion_rl_tpu.envs.legged_robot import \
        LeggedRobotEnv as JEnv
    from rapid_locomotion_rl_tpu_torch import config as tcfg
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    jenv = JEnv(_cfg(jcfg))
    jstate = jenv.initial_state(jax.random.PRNGKey(1234))
    key = jstate.key
    tc = _cfg(tcfg)
    tc.sim.physics_impl = "aos"
    env = LeggedRobotEnv(tc, device="cpu")
    state = env_state_from_jax(jax.tree.map(np.asarray, jstate),
                               device="cpu")
    sampler = JaxKeySampler()
    zeros = torch.zeros((NUM_ENVS, 12))
    sums = []
    for _ in range(STEPS):
        sampler.set_key(key)
        key = jax.random.split(key, 7)[0]
        state, res = env.step(state, zeros, sampler)
        sums.append([float(torch.sum(res.rew)),
                     float(torch.sum(state.sim.base_pos)),
                     float(torch.sum(state.sim.q)),
                     float(torch.sum(res.done))])
    return np.asarray(sums)


def test_port_aos_env_matches_the_golden_trajectory(port_sums):
    with open(GOLDEN) as f:
        golden = np.asarray(json.load(f))
    assert golden.shape == port_sums.shape == (STEPS, 4)
    np.testing.assert_allclose(port_sums, golden, rtol=2e-4, atol=2e-3)
