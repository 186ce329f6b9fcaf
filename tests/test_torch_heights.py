"""Height sensing on a terrain mesh in the port against the JAX package:
the min-of-3 lookups (direct, and through each env's P x P patch, with
points inside and outside the patch), the patch itself, the env's sensor
(``_get_heights`` on both of its rules, the noise vector's height block),
and one env step with ``terrain.measure_heights`` on
(tests/torch_port_helpers.py::mc_env_step, the AoS physics on both sides)
on obs, privileged obs, measured heights and every reward term.

The lookups gather grid samples and take a min, so they agree exactly on
the same inputs; the JAX patch form picks its samples by one-hot
contractions, which are exact too. The step's measured heights come from
each package's own end state (which agree to 1e-4): they are held exactly
where both sample the same cells."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu.ops import contact as JC
from rapid_locomotion_rl_tpu_torch.convert import env_state_from_jax
from rapid_locomotion_rl_tpu_torch.ops import contact as TC
from torch_port_helpers import _grids, assert_env_step_close, mc_env_step

P = 16


@pytest.fixture(scope="module")
def rough():
    """A 60 x 70 grid of random heights (0.1 m cells, 1 m border) with
    bases spread over it and points around each base, some far outside
    its P x P patch (and some off the grid), and a tenth of the points on
    cell edges (k * 0.1 - 1 in float32: a quotient taken as a product
    with the reciprocal lands some of them in the next cell)."""
    rng = np.random.default_rng(0)
    h = rng.uniform(-0.2, 0.2, (60, 70)).astype(np.float32)
    jg, tg = _grids(h, 0.1, 1.0)
    n, npts = 32, 50
    base = np.stack([rng.uniform(-1.2, 5.5, n), rng.uniform(-1.2, 6.5, n)],
                    -1).astype(np.float32)
    off = rng.normal(0, 0.9, (n, npts, 2)).astype(np.float32)
    pts = base[:, None, :] + off
    k = rng.integers(0, 60, (n, npts // 10, 2)).astype(np.float32)
    pts[:, :npts // 10] = k * np.float32(0.1) - np.float32(1.0)
    return jg, tg, base, pts


def test_lookup_cells_match_on_cell_edges(rough):
    """The bilinear lookup's height on points on and off cell edges (the
    cell and the fractions from the true quotient)."""
    jg, tg, _, pts = rough
    ref = JC.terrain_height_and_normal(jg, jnp.asarray(pts[..., 0]),
                                       jnp.asarray(pts[..., 1]))
    got = TC.terrain_height_and_normal(tg, torch.tensor(pts[..., 0]),
                                       torch.tensor(pts[..., 1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-5, atol=1e-5)


def test_min3_direct_matches(rough):
    jg, tg, _, pts = rough
    ref = JC.terrain_height_min3(jg, jnp.asarray(pts[..., 0]),
                                 jnp.asarray(pts[..., 1]))
    got = TC.terrain_height_min3(tg, torch.tensor(pts[..., 0]),
                                 torch.tensor(pts[..., 1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sample_patch_matches(rough):
    jg, tg, base, _ = rough
    ref = JC.sample_patch(jg, jnp.asarray(base[:, 0]),
                          jnp.asarray(base[:, 1]), P)
    got = TC.sample_patch(tg, torch.tensor(base[:, 0]),
                          torch.tensor(base[:, 1]), P)
    for r, o in zip(ref, got):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_min3_patch_matches_inside_and_outside(rough):
    """The patch rule against JAX's, and against the direct rule: equal
    for points inside the patch, different (clamped into it) for some
    outside."""
    jg, tg, base, pts = rough
    bx, by = base[:, 0], base[:, 1]
    ref = JC.terrain_height_min3_patch(
        jg, jnp.asarray(bx), jnp.asarray(by), jnp.asarray(pts[..., 0]),
        jnp.asarray(pts[..., 1]), P)
    got = TC.terrain_height_min3_patch(
        tg, torch.tensor(bx), torch.tensor(by), torch.tensor(pts[..., 0]),
        torch.tensor(pts[..., 1]), P).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref))
    direct = TC.terrain_height_min3(tg, torch.tensor(pts[..., 0]),
                                    torch.tensor(pts[..., 1])).numpy()
    _, ix0, iy0 = TC.sample_patch(tg, torch.tensor(bx), torch.tensor(by), P)
    ix, iy = TC._sense_cells(tg, torch.tensor(pts[..., 0]),
                             torch.tensor(pts[..., 1]))
    inside = (((ix - ix0[:, None]) >= 0) & ((ix - ix0[:, None]) <= P - 2)
              & ((iy - iy0[:, None]) >= 0)
              & ((iy - iy0[:, None]) <= P - 2)).numpy()
    assert inside.any() and (~inside).any()
    np.testing.assert_array_equal(got[inside], direct[inside])
    assert (got[~inside] != direct[~inside]).any()


def _sensing(c):
    c.sim.physics_impl = "aos"
    c.terrain.measure_heights = True
    c.env.num_observations = 42 + 187


@pytest.fixture(scope="module")
def sensing_step():
    return mc_env_step(_sensing)


def test_sensing_set_up_matches(sensing_step):
    (jenv, *_), (tenv, *_) = sensing_step
    assert tenv.num_height_points == jenv.num_height_points == 187
    assert tenv._sense_patch_P == jenv._sense_patch_P
    np.testing.assert_array_equal(tenv.height_points.numpy(),
                                  np.asarray(jenv.height_points))
    np.testing.assert_allclose(tenv.noise_scale_vec.numpy(),
                               np.asarray(jenv.noise_scale_vec), rtol=1e-7)


@pytest.mark.parametrize("patch", [True, False])
def test_get_heights_matches_on_one_state(sensing_step, patch):
    """Both rules of the env's sensor on JAX's end state: through the patch
    (the default) and direct (terrain_patch_size 0)."""
    (jenv, _, jnew, _, _), (tenv, *_) = sensing_step
    ps = (jenv.cfg.sim.terrain_patch_size, tenv.cfg.sim.terrain_patch_size)
    try:
        if not patch:
            jenv.cfg.sim.terrain_patch_size = 0
            tenv.cfg.sim.terrain_patch_size = 0
        ref = np.asarray(jenv._get_heights(jnew.sim))
        tsim = env_state_from_jax(jax.tree.map(np.asarray, jnew),
                                  device="cpu").sim
        got = tenv._get_heights(tsim).numpy()
    finally:
        jenv.cfg.sim.terrain_patch_size, tenv.cfg.sim.terrain_patch_size = ps
    assert np.ptp(ref) > 0.02, "the sensed surface is flat"
    np.testing.assert_array_equal(got, ref)


def test_sensing_env_step_matches_jax(sensing_step):
    """Measured heights exactly where both packages' end states sample the
    same cells: all but a few points, whose base moved across a cell edge
    by a float difference (the states agree to 1e-4) and whose sample then
    comes from the next cell. Then obs (with the height block), privileged
    obs, rewards and every reward term as tests/test_torch_env_trimesh.py
    holds them, on the envs whose every point samples the same cells."""
    jax_side, port_side = sensing_step
    jnew, tnew = jax_side[2], port_side[1]
    ref = np.asarray(jnew.measured_heights)
    got = tnew.measured_heights.numpy()
    assert ref.shape == got.shape == (64, 187)
    assert np.ptp(ref) > 0.02, "the sensed surface is flat"
    same = got == ref
    assert same.mean() >= 0.99, same.mean()
    rows = same.all(-1)
    assert rows.mean() >= 0.9, rows.mean()
    assert_env_step_close(jax_side, port_side, rows=rows)
