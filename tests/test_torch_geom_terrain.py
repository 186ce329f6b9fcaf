"""The terrain lookup kernel's body (csrc/geom_terrain.cuh) built for the
CPU with g++, against its plain version (the port's
ops/soa_physics.py::sample_geom_terrain, through ops/contact.py's
terrain_height_and_normal) and, for the plain version, the JAX package's
_sample_geom_terrain; and the kernel itself on a card (``gpu`` marker).

The lookup half takes the plain version's points and must pick the same
cell for every point, cell edges included (the grid coordinate is a true
quotient on both sides), with heights and normals at rtol/atol 1e-6, the
tolerance tests/test_torch_terrain.py holds the plain lookup to against
JAX. The whole body recomputes the geoms' FK, whose sin and cos are
glibc's under g++ and PyTorch's own in the plain version: a last-place
difference in a geom's x or y can move a point that lies on a cell edge
into the next cell. Such entries are counted (at most 0.1%, and only where
the plain version's grid coordinate lies within 1e-5 cells of an edge);
the others agree at the repo's state tolerance, rtol/atol 2e-5
(tests/test_pallas_physics.py)."""

import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu.config import SimCfg as JSimCfg
from rapid_locomotion_rl_tpu.models import load_urdf as jload_urdf
from rapid_locomotion_rl_tpu.ops.contact import sample_patch
from rapid_locomotion_rl_tpu.ops.limb_dynamics import layout_for as jlayout
from rapid_locomotion_rl_tpu.ops.soa_physics import _sample_geom_terrain
from rapid_locomotion_rl_tpu_torch.config import SimCfg
from rapid_locomotion_rl_tpu_torch.models import load_urdf
from rapid_locomotion_rl_tpu_torch.ops import contact as TC
from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
from rapid_locomotion_rl_tpu_torch.ops.soa_physics import (
    _v3, check_supported, fk_geom_xy, sample_geom_terrain)
from torch_port_helpers import (MC, TINY, _grids, generated_grid,
                                on_terrain, physics_inputs, torch_inputs)

P = SimCfg().terrain_patch_size          # 16: the per-call square
WINDOWS = ("none", "square", "blocked")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to build the lookup's body")
    path = CP.build_geom_terrain_host_library(
        str(tmp_path_factory.mktemp("gtlib")))
    return CP.load_geom_terrain_host_library(path)


@pytest.fixture(scope="module")
def grids():
    """A random grid (64 x 200 cells of 0.1 m, 1 m border) and the
    collision grid of the TerrainCfg mix, as (JAX grid, torch grid)."""
    rng = np.random.default_rng(5)
    h = rng.normal(0, 0.2, (64, 200)).astype(np.float32)
    return {"random": _grids(h, 0.1, 1.0), "mix": generated_grid()}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    p = tmp_path_factory.mktemp("hopper") / "tiny.urdf"
    p.write_text(TINY)
    return {"mc": (MC, load_urdf(MC)), "hopper": (str(p), load_urdf(str(p)))}


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _window(kind, grid, bx, by):
    """The env's windows (envs/legged_robot.py::_window_rule): none, the
    square of P + 8 cells, the 32 x 128 column block."""
    if kind == "none":
        return None
    if kind == "square":
        return TC.square_window(grid, bx, by, P + 8)
    return TC.blocked_window(grid, bx, by)


def _grid_args(grid, window):
    """The lookup's grid and window arguments (no window: (0, 0, H, W))."""
    H, W = grid.height.shape
    ix0, iy0, rows, cols = ((None, None, H, W) if window is None
                            else window)
    return [_ptr(grid.height), H, W, grid.border_size,
            grid.horizontal_scale, _ptr(ix0), _ptr(iy0), rows, cols]


def host_lookup(lib, grid, px, py, window):
    """The lookup half on points [n, m]: heights, normals, cells."""
    px, py = px.contiguous(), py.contiguous()
    n, m = px.shape
    h = torch.empty(n, m)
    nrm = torch.empty(n, m, 3)
    cix = torch.empty(n, m, dtype=torch.int64)
    ciy = torch.empty(n, m, dtype=torch.int64)
    err = lib.rl_geom_lookup_host(_ptr(px), _ptr(py), n, m,
                                  *_grid_args(grid, window), _ptr(h),
                                  _ptr(nrm), _ptr(cix), _ptr(ciy))
    assert err == 0
    return h, nrm, cix, ciy


def host_body(lib, model, state, tau, params, imp, grid, window):
    """The whole body on the packed input: (heights [N, ng], normals
    [N, ng, 3], xy [2 ng, N])."""
    layout = check_supported(model, SimCfg(), terrain=grid)
    cst = torch.from_numpy(CP.pack_constants(model, SimCfg(), layout))
    x = CP.pack_inputs(model, state, tau, params, imp, grid)
    N, ng = x.shape[1], model.ng
    ct = CP.terrain_row(model, imp is not None)
    xy = torch.empty(2 * ng, N)
    err = lib.rl_geom_terrain_host(_ptr(x), _ptr(cst), N, layout.D,
                                   layout.K, ng, ct,
                                   *_grid_args(grid, window), _ptr(xy))
    assert err == 0
    hh = x[ct:ct + ng].T
    nn = x[ct + ng:ct + 4 * ng].T.reshape(N, ng, 3)
    return hh, nn, xy


def _points(rng, grid, n=24, m=30):
    """Bases over the grid and, around each, points inside both windows
    (0.6 m), points far outside them (4 m, the windows clamp their cells)
    and points exactly on cell edges (k * scale - border in float32)."""
    H, W = grid.height.shape
    s, b = grid.horizontal_scale, grid.border_size
    bx = rng.uniform(0.3, (H - 1) * s - b - 0.3, n).astype(np.float32)
    by = rng.uniform(0.3, (W - 1) * s - b - 0.3, n).astype(np.float32)
    near = rng.uniform(-0.6, 0.6, (n, m // 3, 2)).astype(np.float32)
    far = rng.uniform(-4.0, 4.0, (n, m // 3, 2)).astype(np.float32)
    pts = np.concatenate([near, far], 1) + np.stack([bx, by], -1)[:, None]
    k = np.stack([rng.integers(0, H, (n, m - 2 * (m // 3))),
                  rng.integers(0, W, (n, m - 2 * (m // 3)))], -1)
    edge = k.astype(np.float32) * np.float32(s) - np.float32(b)
    pts = np.concatenate([pts, edge], 1)
    t = lambda a: torch.tensor(np.ascontiguousarray(a))  # noqa: E731
    return t(bx), t(by), t(pts[..., 0]), t(pts[..., 1])


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("grid_name", ["random", "mix"])
def test_lookup_half_matches_plain(lib, grids, grid_name, window):
    """The lookup half on the plain version's points: the same cells on
    every point, heights and normals at 1e-6."""
    _, grid = grids[grid_name]
    bx, by, px, py = _points(np.random.default_rng(3), grid)
    win = _window(window, grid, bx, by)
    h, nrm, cix, ciy = host_lookup(lib, grid, px, py, win)
    ix, iy, _, _ = TC._cells(grid, px, py, win)
    assert torch.equal(cix, ix) and torch.equal(ciy, iy)
    ref_h, ref_n = TC.terrain_height_and_normal(grid, px, py, win)
    torch.testing.assert_close(h, ref_h, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(nrm, ref_n, rtol=1e-6, atol=1e-6)
    # the edge points are on edges, and the far ones are clamped
    fx = (px + grid.border_size) / TC._scale(grid, px)
    assert int((fx[:, 20:] == torch.floor(fx[:, 20:])).sum()) > 100
    direct = TC._cells(grid, px, py, None)[0]
    assert (window != "none") == bool((direct != ix).any())


def _body_inputs(model, kind, grid, n, seed):
    """(state, tau, params, imp) of ``physics_inputs`` over ``grid``."""
    state, params, tau, imp = physics_inputs(model, n, seed, kind)
    state, params, tau, imp = torch_inputs(on_terrain(state, grid, seed),
                                           params, tau, imp)
    return state, tau, params, imp


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("robot", ["mc", "hopper"])
def test_body_matches_sample_geom_terrain(lib, grids, models, robot,
                                          window):
    """The whole body on the packed input against sample_geom_terrain:
    its (x, y) at 1e-5, its cells (from the lookup half on its own
    points) against the plain version's, and the entries whose cell is
    the same at 2e-5 (the module docstring has the rule for the others)."""
    _, grid = grids["mix"]
    model = models[robot][1]
    kind = "ground" if robot == "mc" else "hopper"
    state, tau, params, imp = _body_inputs(model, kind, grid, 200, 9)
    bx, by = state.base_pos[:, 0], state.base_pos[:, 1]
    win = _window(window, grid, bx, by)
    sim = SimCfg()
    if window == "none":
        sim.terrain_patch_size = 0         # the whole grid
    layout = check_supported(model, sim, terrain=grid)
    hh, nn, xy = host_body(lib, model, state, tau, params, imp, grid, win)
    ref_h, ref_n = CP.geom_terrain_at(model, sim, layout, state, grid, win)

    # the FK half's points, and each side's cells
    pxy = fk_geom_xy(model, layout, _v3(state.base_pos),
                     tuple(state.base_quat[:, i] for i in range(4)),
                     list(state.q.T))
    px = torch.stack([x for x, _ in pxy], -1)
    py = torch.stack([y for _, y in pxy], -1)
    kx, ky = xy[0::2].T, xy[1::2].T
    torch.testing.assert_close(kx, px, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ky, py, rtol=1e-5, atol=1e-5)
    ix, iy, _, _ = TC._cells(grid, px, py, win)
    _, _, kix, kiy = host_lookup(lib, grid, kx, ky, win)
    moved = (kix != ix) | (kiy != iy)
    assert moved.float().mean().item() <= 1e-3
    s = TC._scale(grid, px)
    for f, differs in (((px + grid.border_size) / s, kix != ix),
                       ((py + grid.border_size) / s, kiy != iy)):
        to_edge = (f - torch.round(f)).abs()
        assert bool((to_edge[differs] <= 1e-5).all())
    keep = ~moved
    torch.testing.assert_close(hh[keep], ref_h[keep], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(nn[keep], ref_n[keep], rtol=2e-5, atol=2e-5)
    # the grid under the geoms is not flat
    assert (ref_n[..., 2] < 0.999).any()


@pytest.mark.parametrize("robot", ["mc", "hopper"])
def test_fk_half_matches_plain(lib, grids, models, robot):
    """The FK half alone (rl_geom_xy_host) against fk_geom_xy, at the
    geom-position tolerance of tests/test_pallas_physics.py."""
    _, grid = grids["mix"]
    model = models[robot][1]
    kind = "ground" if robot == "mc" else "hopper"
    state, tau, params, imp = _body_inputs(model, kind, grid, 64, 4)
    layout = check_supported(model, SimCfg())
    cst = torch.from_numpy(CP.pack_constants(model, SimCfg(), layout))
    x = CP.pack_inputs(model, state, tau, params, imp)
    xy = torch.empty(2 * model.ng, x.shape[1])
    assert lib.rl_geom_xy_host(_ptr(x), _ptr(cst), x.shape[1], layout.D,
                               layout.K, model.ng, _ptr(xy)) == 0
    ref = fk_geom_xy(model, layout, _v3(state.base_pos),
                     tuple(state.base_quat[:, i] for i in range(4)),
                     list(state.q.T))
    for g, (rx, ry) in enumerate(ref):
        torch.testing.assert_close(xy[2 * g], rx, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(xy[2 * g + 1], ry, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", ["direct", "patch", "hoisted"])
def test_sample_geom_terrain_matches_jax(grids, models, form):
    """The plain version against the JAX package's _sample_geom_terrain on
    one Mini Cheetah state: direct gathers (patch size 0), the per-call
    P x P patch, and the patch of P + 8 cells hoisted as
    tests/test_soa_physics.py builds it (the port's square window of the
    same size). The JAX patch lookup is the einsum form: 1e-5, as
    tests/test_torch_terrain.py holds it."""
    jg, tg = grids["mix"]
    path, model = models["mc"]
    jm = jload_urdf(path)
    state, params, tau, imp = physics_inputs(model, 9, 4, "ground")
    state = on_terrain(state, tg, 4)
    jsim, sim = JSimCfg(), SimCfg()
    if form == "direct":
        jsim.terrain_patch_size = sim.terrain_patch_size = 0
    j = {k: jnp.asarray(v) for k, v in state.items()}
    jbase = tuple(j["base_pos"][:, i] for i in range(3))
    jquat = tuple(j["base_quat"][:, i] for i in range(4))
    jq = [j["q"][:, k] for k in range(model.nv)]
    patch3, win = None, None
    t = {k: torch.tensor(v) for k, v in state.items()}
    if form == "hoisted":
        patch3 = sample_patch(jg, jbase[0], jbase[1], P + 8)
        win = TC.square_window(tg, t["base_pos"][:, 0], t["base_pos"][:, 1],
                               P + 8)
        np.testing.assert_array_equal(win.ix0.numpy(),
                                      np.asarray(patch3[1]))
    g_h, g_n = _sample_geom_terrain(jm, jlayout(jm), jsim, jg, jbase, jquat,
                                    jq, patch3=patch3)
    hh, nn = sample_geom_terrain(
        model, check_supported(model, sim), sim, tg, _v3(t["base_pos"]),
        tuple(t["base_quat"][:, i] for i in range(4)), list(t["q"].T), win)
    ref_h = np.stack([np.asarray(h) for h in g_h], -1)
    ref_n = np.stack([np.stack([np.asarray(c) for c in n], -1)
                      for n in g_n], 1)
    np.testing.assert_allclose(hh.numpy(), ref_h, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nn.numpy(), ref_n, rtol=1e-5, atol=1e-5)
    assert (ref_n[..., 2] < 0.999).any()


def test_launch_refuses_cpu_tensors(grids, models):
    """On CPU tensors the lookup's launch refuses their device: nothing is
    built, launched or counted (the CPU path is the plain version)."""
    _, grid = grids["mix"]
    model = models["mc"][1]
    state, tau, params, imp = _body_inputs(model, "ground", grid, 4, 0)
    layout = check_supported(model, SimCfg(), terrain=grid)
    cst = torch.from_numpy(CP.pack_constants(model, SimCfg(), layout))
    x = CP.pack_inputs(model, state, tau, params, imp, grid)
    assert x.shape[0] == CP.terrain_row(model, True) + 4 * model.ng
    before = CP.KERNEL.geom_terrain_launches
    with pytest.raises(ValueError, match="CUDA"):
        CP.KERNEL.launch_geom_terrain(x, cst, layout, model.ng,
                                      CP.terrain_row(model, True), grid)
    assert CP.KERNEL.geom_terrain_launches == before
    assert CP.KERNEL._gt_lib is None


@pytest.mark.gpu
@pytest.mark.parametrize("window", WINDOWS)
def test_cuda_lookup_matches_plain(grids, models, window):
    """Runs on a machine with a CUDA card (python -m pytest -m gpu): the
    kernel against its plain version on the card, and the physics call
    through it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, grid = grids["mix"]
    grid = grid._replace(height=grid.height.cuda())
    model = models["mc"][1]
    state, params, tau, imp = physics_inputs(model, 4000, 7, "ground")
    state, params, tau, imp = torch_inputs(
        on_terrain(state, grids["mix"][1], 7), params, tau, imp)
    state = type(state)(*(t.cuda() for t in state))
    params = type(params)(*(t.cuda() for t in params))
    tau, imp = tau.cuda(), imp.cuda()
    sim = SimCfg()
    if window == "none":
        sim.terrain_patch_size = 0
    win = _window(window, grid, state.base_pos[:, 0], state.base_pos[:, 1])
    layout = check_supported(model, sim, terrain=grid)
    cst = CP.KERNEL.table(model, sim, layout, state.q.device)
    x = CP.pack_inputs(model, state, tau, params, imp, grid)
    ct = CP.terrain_row(model, True)
    before = CP.KERNEL.geom_terrain_launches
    CP.KERNEL.launch_geom_terrain(x, cst, layout, model.ng, ct, grid, win)
    torch.cuda.synchronize()
    assert CP.KERNEL.geom_terrain_launches == before + 1
    ref_h, ref_n = CP.geom_terrain_at(model, sim, layout, state, grid, win)
    ng = model.ng
    torch.testing.assert_close(x[ct:ct + ng].T, ref_h, rtol=2e-5, atol=2e-5)
    close = ((x[ct + ng:ct + 4 * ng].T.reshape(-1, ng, 3) - ref_n).abs()
             <= 2e-5 + 2e-5 * ref_n.abs())
    assert close.float().mean().item() >= 0.999
