"""The port's terrain (rapid_locomotion_rl_tpu_torch.envs.terrain and
ops.contact) against the JAX package's.

Terrain generation is NumPy in both packages, drawing from one
RandomState in the same order, so grids and origins agree exactly. The
lookups are plain 4-corner gathers in the port; the JAX package reads the
same corners through a per-env patch with one-hot einsums, which agree
with the 4-corner formula up to float reassociation: 1e-5 on heights and
normals, the tolerance of tests/test_terrain.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu import config as jcfg
from rapid_locomotion_rl_tpu.envs.terrain import Terrain as JTerrain
from rapid_locomotion_rl_tpu.ops import contact as JC
from rapid_locomotion_rl_tpu_torch import config as tcfg
from rapid_locomotion_rl_tpu_torch.envs.terrain import Terrain
from rapid_locomotion_rl_tpu_torch.ops import contact as TC


def _terrain_cfgs(curriculum, proportions=None):
    out = []
    for mod in (jcfg, tcfg):
        c = mod.TerrainCfg()
        c.num_rows, c.num_cols = 3, 5
        c.terrain_length = c.terrain_width = 4.0
        c.border_size = 2.0
        c.curriculum = curriculum
        if proportions is not None:
            c.terrain_proportions = proportions
        out.append(c)
    return out


@pytest.fixture(scope="module", params=[True, False],
                ids=["curriculum", "random"])
def terrains(request):
    """The default TerrainCfg mix (slopes, rough slopes, stairs, obstacles,
    stepping stones) at 3 x 5 cells of 4 m, built by both packages."""
    jc, tc = _terrain_cfgs(request.param)
    return (JTerrain(jc, 20, seed=3), jc), (Terrain(tc, 20, seed=3), tc)


def test_height_field_and_origins_identical(terrains):
    (jt, jc), (tt, tc) = terrains
    assert np.abs(jt.height_field_raw).max() > 0, "terrain should not be flat"
    np.testing.assert_array_equal(tt.height_field_raw, jt.height_field_raw)
    np.testing.assert_array_equal(tc.env_origins, jc.env_origins)


def test_grids_identical(terrains):
    (jt, _), (tt, _) = terrains
    jg = jt.as_grid(0.9, 0.8, 0.1)
    tg = tt.as_grid(0.9, 0.8, 0.1, device="cpu")
    np.testing.assert_array_equal(tg.height.numpy(), np.asarray(jg.height))
    jcg = jt.as_collision_grid(0.9, 0.8, 0.1, upsample=2,
                               slope_threshold=0.75)
    tcg = tt.as_collision_grid(0.9, 0.8, 0.1, upsample=2,
                               slope_threshold=0.75, device="cpu")
    assert tcg.height.dtype == torch.float32
    np.testing.assert_array_equal(tcg.height.numpy(), np.asarray(jcg.height))
    for f in ("horizontal_scale", "border_size", "static_friction",
              "dynamic_friction", "restitution"):
        assert getattr(tcg, f) == getattr(jcg, f), f


def test_flagship_mix_is_flat():
    """config_mini_cheetah's proportions select uniform noise of magnitude
    0: its grid is flat, which is why the physics tests use other grids."""
    jc, tc = _terrain_cfgs(False, [0, 0, 0, 0, 0, 0, 0, 0, 1.0])
    jc.terrain_noise_magnitude = tc.terrain_noise_magnitude = 0.0
    jt, tt = JTerrain(jc, 4, seed=1), Terrain(tc, 4, seed=1)
    assert not tt.height_field_raw.any()
    np.testing.assert_array_equal(tt.height_field_raw, jt.height_field_raw)


def _grid(seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 0.2, (64, 200)).astype(np.float32)
    args = dict(horizontal_scale=0.1, border_size=1.0, static_friction=1.0,
                dynamic_friction=1.0, restitution=0.0)
    return (rng, JC.TerrainGrid(height=jnp.asarray(h), **args),
            TC.TerrainGrid(height=torch.tensor(h), **args))


def _points(rng, N=16, ng=7, spread=0.9):
    base_x = rng.uniform(0.5, 4.5, N).astype(np.float32)
    # exact column-block stride boundaries (grid columns 0/64/128 at world
    # y = -1.0 + 6.4 k) among random bases, as tests/test_terrain.py
    base_y = np.concatenate([rng.uniform(0.0, 17.0, N - 4),
                             [5.4, 11.8, 0.2, 12.0]]).astype(np.float32)
    gx = base_x[:, None] + rng.uniform(-spread, spread, (N, ng)).astype(
        np.float32)
    gy = base_y[:, None] + rng.uniform(-spread, spread, (N, ng)).astype(
        np.float32)
    return base_x, base_y, gx, gy


def test_direct_lookup_matches_jax():
    rng, jg, tg = _grid(5)
    _, _, gx, gy = _points(rng, spread=3.0)
    hj, nj = JC.terrain_height_and_normal(jg, jnp.asarray(gx),
                                          jnp.asarray(gy))
    ht, nt = TC.terrain_height_and_normal(tg, torch.tensor(gx),
                                          torch.tensor(gy))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-6,
                               atol=1e-6)
    hb = TC.terrain_height_bilinear(tg, torch.tensor(gx), torch.tensor(gy))
    np.testing.assert_allclose(
        hb.numpy(), np.asarray(JC.terrain_height_bilinear(
            jg, jnp.asarray(gx), jnp.asarray(gy))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spread", [0.6, 4.0], ids=["inside", "clamped"])
@pytest.mark.parametrize("form", ["square", "blocked"])
def test_window_lookup_matches_jax_patch(form, spread):
    """The port's window clamp against the JAX patch lookups (the einsum
    form the env runs, and the take form). ``inside`` keeps geoms within
    0.6 m of the base, inside both windows; ``clamped`` puts them up to
    4 m away, outside the 16-cell square and the 32-row block, so the
    window clamps their cells as the patch does."""
    rng, jg, tg = _grid(6)
    base_x, base_y, gx, gy = _points(rng, spread=spread)
    jx, jy = jnp.asarray(base_x), jnp.asarray(base_y)
    tx, ty = torch.tensor(base_x), torch.tensor(base_y)
    if form == "square":
        patch, ix0, iy0 = JC.sample_patch(jg, jx, jy, 16)
        win = TC.square_window(tg, tx, ty, 16)
    else:
        blocks = JC.make_col_blocks(jg)
        patch, ix0, iy0 = JC.sample_patch_blocked(blocks, jg, jx, jy)
        win = TC.blocked_window(tg, tx, ty)
        assert (win.rows, win.cols) == (32, 128)
    np.testing.assert_array_equal(win.ix0.numpy(), np.asarray(ix0))
    np.testing.assert_array_equal(win.iy0.numpy(), np.asarray(iy0))
    ht, nt = TC.terrain_height_and_normal(tg, torch.tensor(gx),
                                          torch.tensor(gy), win)
    hm, nm = JC.patch_height_and_normal_mm(jg, patch, ix0, iy0,
                                           jnp.asarray(gx), jnp.asarray(gy))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hm), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nm), rtol=1e-5,
                               atol=1e-5)
    hk, nk = JC.patch_height_and_normal(jg, patch, ix0, iy0,
                                        jnp.asarray(gx), jnp.asarray(gy))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hk), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nk), rtol=1e-6,
                               atol=1e-6)
    direct, _ = TC.terrain_height_and_normal(tg, torch.tensor(gx),
                                             torch.tensor(gy))
    differs = (direct - ht).abs().max().item() > 1e-3
    assert differs == (spread > 1.0), "the clamp should act only off-window"
