"""The port's interop helpers against the JAX package's:
``envs/vec_env.py::VecEnvAdapter`` (Go1 on the plane, the general physics
step on both sides, a few steps from one converted state), the trajectory
helpers of ``learn/trajectories.py`` on random dones, and
``envs/terrain_native.py`` on each function of the native library it
binds (the five generators and the trimesh conversion), which raises
where the JAX copy would fall back to NumPy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu import config as jcfg
from rapid_locomotion_rl_tpu.envs import terrain_native as JTN
from rapid_locomotion_rl_tpu.envs.legged_robot import LeggedRobotEnv as JEnv
from rapid_locomotion_rl_tpu.envs.vec_env import VecEnvAdapter as JVec
from rapid_locomotion_rl_tpu.learn import trajectories as JT
from rapid_locomotion_rl_tpu_torch import config as tcfg
from rapid_locomotion_rl_tpu_torch.convert import env_state_from_jax
from rapid_locomotion_rl_tpu_torch.envs import terrain_native as TTN
from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
from rapid_locomotion_rl_tpu_torch.envs.vec_env import VecEnvAdapter
from rapid_locomotion_rl_tpu_torch.learn import trajectories as TT

NV = 16


def _go1(mod):
    c = mod.config_go1()
    c.env.num_envs = NV
    c.sim.physics_impl = "aos"
    c.noise.add_noise = False
    c.domain_rand.push_robots = False
    return c


@pytest.fixture(scope="module")
def vec_pair():
    jv = JVec(JEnv(_go1(jcfg)), seed=3)
    tv = VecEnvAdapter(LeggedRobotEnv(_go1(tcfg), device="cpu"), seed=3)
    tv.state = env_state_from_jax(jax.tree.map(np.asarray, jv.state),
                                  device="cpu")
    return jv, tv


def test_vec_env_steps_match_jax(vec_pair):
    """Three steps of each adapter with the same actions from one state:
    obs dicts, rewards and dones (on envs that did not reset), and the
    mirrored buffers."""
    jv, tv = vec_pair
    rng = np.random.default_rng(0)
    for _ in range(3):
        a = rng.normal(0, 0.3, (NV, 12)).astype(np.float32)
        jo, jr, jd, _ = jv.step(jnp.asarray(a))
        to, tr, td, info = tv.step(a)
        keep = ~np.asarray(jd)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(tr.numpy()[keep], np.asarray(jr)[keep],
                                   rtol=1e-4, atol=1e-4)
        for k in ("obs", "privileged_obs", "obs_history"):
            np.testing.assert_allclose(to[k].numpy()[keep],
                                       np.asarray(jo[k])[keep],
                                       rtol=1e-4, atol=1e-4, err_msg=k)
    assert "raw_reward_mean" in info
    np.testing.assert_allclose(tv.root_states.numpy(),
                               np.asarray(jv.root_states), rtol=1e-4,
                               atol=1e-4)
    for name in ("dof_pos", "dof_vel", "commands", "episode_length_buf"):
        np.testing.assert_allclose(getattr(tv, name).numpy(),
                                   np.asarray(getattr(jv, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for k, v in tv.get_observations().items():
        assert torch.equal(v, to[k])


def test_vec_env_resets(vec_pair):
    _, tv = vec_pair
    tv.episode_length_buf = torch.full((NV,), 7)
    tv.reset_idx([1, 4])
    ep = tv.episode_length_buf
    assert ep[1] == 0 and ep[4] == 0 and ep[0] == 7
    tv.reset_evaluation_envs()
    assert (tv.episode_length_buf[tv.num_train_envs:] == 0).all()
    obs = tv.reset()
    assert obs["obs"].shape == (NV, tv.num_obs)
    assert (tv.episode_length_buf == 1).all()
    assert tv.get_privileged_observations().shape == (
        NV, tv.num_privileged_obs)


def _dones(seed, T=12, N=6):
    rng = np.random.default_rng(seed)
    d = rng.uniform(size=(T, N)) < 0.2
    d[:, 0] = False           # one env never done
    d[-1, 1] = True           # one done at the last step
    return d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trajectory_helpers_match_jax(seed):
    d = _dones(seed)
    T, N = d.shape
    x = np.random.default_rng(seed).normal(size=(T, N, 3)).astype(
        np.float32)
    ref = JT.split_and_pad_trajectories(jnp.asarray(x), jnp.asarray(d))
    got = TT.split_and_pad_trajectories(torch.tensor(x), torch.tensor(d))
    for r, o in zip(ref, got):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    back = TT.unpad_trajectories(got[0], torch.tensor(d), N)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(JT.unpad_trajectories(ref[0], jnp.asarray(d), N)))
    assert int(got[1].sum()) == T * N
    assert int(got[1][0].sum()) == N + int(d[:-1].sum())


def test_recurrent_mini_batches_match_jax():
    d = _dones(5, T=8, N=8)
    rng = np.random.default_rng(5)
    data = {k: rng.normal(size=(8, 8, 4)).astype(np.float32)
            for k in ("obs", "priv", "hist", "actions")}
    ref = JT.recurrent_mini_batches({k: jnp.asarray(v) for k, v in
                                     data.items()}, jnp.asarray(d), 2)
    got = TT.recurrent_mini_batches({k: torch.tensor(v) for k, v in
                                     data.items()}, torch.tensor(d), 2)
    assert len(got) == len(ref) == 2
    for r, o in zip(ref, got):
        assert set(r) == set(o) == {"obs", "priv", "hist", "actions",
                                    "masks"}
        for k in r:
            np.testing.assert_array_equal(o[k].numpy(), np.asarray(r[k]))


# the C arguments after (hf, width, length), as tests/test_terrain.py and
# the JAX package's terrain take them
NATIVE_CASES = {
    "random_uniform_terrain": (-0.05, 0.05, 0.005, 0.2, 0.005, 0.1, 7),
    "pyramid_sloped_terrain": (0.4, 3.0, 0.005, 0.1),
    "pyramid_stairs_terrain": (0.31, -0.1, 3.0, 0.005, 0.1),
    "discrete_obstacles_terrain": (0.15, 1.0, 2.0, 20, 3.0, 0.005, 0.1, 9),
    "stepping_stones_terrain": (0.8, 0.25, 0.05, 3.0, -1.0, 0.005, 0.1, 11),
}


@pytest.mark.parametrize("name", sorted(NATIVE_CASES))
def test_terrain_native_generators_match_jax(name):
    assert JTN.available()
    args = NATIVE_CASES[name]
    ref = np.zeros((80, 80), np.int16)
    getattr(JTN._load(), name)(ref, 80, 80, *args)
    got = TTN.generate(name, np.zeros((80, 80), np.int16), *args)
    np.testing.assert_array_equal(got, ref)
    assert np.ptp(got) > 0, "the generator left the field flat"


def test_terrain_native_trimesh_matches_jax():
    hf = np.zeros((50, 60), np.int16)
    hf[20:30, 20:30] = 100
    hf[5:8, 40:50] = -40
    ref = JTN.convert_heightfield_to_trimesh(hf, 0.1, 0.005, 0.75)
    got = TTN.convert_heightfield_to_trimesh(hf, 0.1, 0.005, 0.75)
    for r, o in zip(ref, got):
        np.testing.assert_array_equal(o, r)


def test_terrain_native_raises_without_the_library(monkeypatch, tmp_path):
    monkeypatch.setattr(TTN, "_lib", None)
    monkeypatch.setattr(TTN, "LIB_PATH", str(tmp_path / "missing.so"))
    with pytest.raises(FileNotFoundError, match="make -C native"):
        TTN.convert_heightfield_to_trimesh(np.zeros((4, 4), np.int16), 0.1,
                                           0.005)
    with pytest.raises(KeyError):
        TTN.generate("no_such_terrain", np.zeros((4, 4), np.int16))
