"""The CUDA kernel's per-env body (csrc/substep_chain.cuh) built for the CPU
with g++, against the port's plain physics step, through the same packing
as the CUDA wrapper; and the kernel itself on a card (``gpu`` marker).

Same arithmetic in the same order: flight and hopper states agree to the
tolerances of tests/test_pallas_physics.py (2e-5 on state, 2e-4/2e-3 on
contact reports, 1e-5 on geom positions); grounded Go1 states by the bulk
rule of tests/test_soa_physics.py. Every variant of the host build is held
to the plain version: plane or terrain, with or without the implicit-PD
input, with or without the world boxes of the HLP corridor. The body runs
as a team of lanes in phases; a second build runs each phase's lanes in
reverse and must give the same bits (a race between lanes would not)."""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu_torch.config import SimCfg
from rapid_locomotion_rl_tpu_torch.models import load_urdf
from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
from rapid_locomotion_rl_tpu_torch.ops.soa_physics import physics_step_soa
from rapid_locomotion_rl_tpu_torch.envs.world import default_corridor
from torch_port_helpers import (GO1, MC, TINY, assert_step_close,
                                assert_step_close_walls, generated_grid,
                                near_walls, on_terrain, physics_inputs,
                                step_grid, torch_inputs, wall_depth)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to build the kernel body")
    path = CP.build_host_library(str(tmp_path_factory.mktemp("hostlib")))
    return CP.load_host_library(path)


@pytest.fixture(scope="module")
def host_lib_reversed(tmp_path_factory):
    """The same body built with each team phase's lanes run last to first."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to build the kernel body")
    path = CP.build_host_library(str(tmp_path_factory.mktemp("hostlib_rev")),
                                 lanes_reversed=True)
    return CP.load_host_library(path)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    p = tmp_path_factory.mktemp("hopper") / "tiny.urdf"
    p.write_text(TINY)
    return {"hopper": load_urdf(str(p)), "go1": load_urdf(GO1),
            "mc": load_urdf(MC)}


@pytest.mark.parametrize("robot,kind,with_imp", [
    ("hopper", "hopper", False),
    ("hopper", "hopper", True),
    ("go1", "flight", True),
    ("go1", "ground", True),
    ("go1", "ground", False),
])
def test_host_kernel_matches_plain(host_lib, models, robot, kind, with_imp):
    model = models[robot]
    n = 200 if robot == "hopper" else 64
    state, params, tau, imp = torch_inputs(
        *physics_inputs(model, n, 7, kind))
    imp = imp if with_imp else None
    ref = physics_step_soa(model, SimCfg(), state, tau, params,
                           implicit_damp=imp)
    out = CP.physics_step_host(host_lib, model, SimCfg(), state, tau, params,
                               implicit_damp=imp)
    if kind != "flight":
        assert ref.contact_report.abs().max() > 0.0
    assert_step_close(ref, out, kind)


@pytest.mark.parametrize("robot,kind,with_imp", [
    ("hopper", "hopper", True),
    ("hopper", "hopper", False),
    ("mc", "flight", True),
    ("mc", "ground", True),
])
def test_host_kernel_terrain_matches_plain(host_lib, models, robot, kind,
                                           with_imp):
    """The terrain variant (4 ng extra input rows of per-geom height and
    normal): the hopper on the step grid, Mini Cheetah over the generated
    grid of slopes, stairs and obstacles."""
    model = models[robot]
    state, params, tau, imp = physics_inputs(model, 200 if robot == "hopper"
                                             else 64, 8, kind)
    if robot == "hopper":
        _, grid = step_grid()
    else:
        _, grid = generated_grid()
        state = on_terrain(state, grid, 9)
    state, params, tau, imp = torch_inputs(state, params, tau, imp)
    imp = imp if with_imp else None
    ref = physics_step_soa(model, SimCfg(), state, tau, params,
                           terrain=grid, implicit_damp=imp)
    out = CP.physics_step_host(host_lib, model, SimCfg(), state, tau, params,
                               implicit_damp=imp, terrain=grid)
    if kind != "flight":
        assert ref.contact_report.abs().max() > 0.0
    assert_step_close(ref, out, kind)


@pytest.mark.parametrize("robot,kind,with_imp,terrain", [
    ("hopper", "hopper", False, False),
    ("hopper", "hopper", True, False),
    ("hopper", "hopper", False, True),
    ("hopper", "hopper", True, True),
    ("mc", "flight", True, False),
    ("mc", "flight", False, True),
    ("mc", "ground", False, False),
    ("mc", "ground", True, True),
])
def test_host_kernel_world_matches_plain(host_lib, models, robot, kind,
                                         with_imp, terrain):
    """The world variant: the hopper's states in the 1.2 x 0.5 m corridor
    of tests/test_pallas_physics.py::test_pallas_world_boxes (at the
    origin; on the step grid for the terrain cases); Mini Cheetah in the
    default corridor around origins spread over the plane or the generated
    grid, its spheres clear of, touching, crossing and inside the walls
    (flight at 0.75 m, inside the walls' height). Flight and hopper states
    clear of the walls agree strictly, those in a wall at the strict
    tolerances in bulk; grounded states by the bulk rule."""
    model = models[robot]
    n = 200 if robot == "hopper" else 64
    state, params, tau, imp = physics_inputs(model, n, 10, kind)
    if robot == "hopper":
        boxes = default_corridor(1.2, 0.5, wall_height=1.0)
        origins = np.zeros((n, 3), np.float32)
        grid = step_grid()[1] if terrain else None
    else:
        boxes = default_corridor()
        state, origins = near_walls(state, 11, 0.75 if kind == "flight"
                                    else None)
        grid = None
        if terrain:
            grid = generated_grid()[1]
            rel = state["base_pos"][:, :2] - origins[:, :2]
            state = on_terrain(state, grid, 12)
            origins[:, :2] = state["base_pos"][:, :2] - rel
    state, params, tau, imp = torch_inputs(state, params, tau, imp)
    imp = imp if with_imp else None
    kw = dict(terrain=grid, implicit_damp=imp, world_boxes=boxes,
              env_origin=torch.tensor(origins))
    ref = physics_step_soa(model, SimCfg(), state, tau, params, **kw)
    out = CP.physics_step_host(host_lib, model, SimCfg(), state, tau, params,
                               **kw)
    assert ref.contact_report[..., :2].abs().max() > 0.1, "no wall is hit"
    if kind == "ground":
        assert_step_close(ref, out, kind)
    else:
        # strictly clear of the walls, in bulk in them (the rule and why:
        # torch_port_helpers.assert_step_close_walls)
        assert_step_close_walls(ref, out, wall_depth(model, boxes,
                                                     ref.geom_pos, origins))


@pytest.mark.parametrize("robot,kind,terrain,fixed,world", [
    ("hopper", "hopper", False, False, False),
    ("hopper", "hopper", False, True, False),
    ("hopper", "hopper", True, False, False),
    ("hopper", "hopper", True, True, False),
    ("hopper", "hopper", False, True, True),
    ("hopper", "hopper", False, False, True),
    ("hopper", "hopper", True, False, True),
    ("hopper", "hopper", True, True, True),
    ("go1", "ground", False, False, False),
    ("go1", "ground", False, True, False),
    ("mc", "flight", True, False, False),
    ("mc", "ground", True, False, False),
    ("mc", "flight", True, True, False),
    ("mc", "ground", True, True, False),
    ("mc", "ground", False, False, True),
    ("mc", "ground", False, True, True),
    ("mc", "flight", True, False, True),
    ("mc", "ground", True, True, True),
])
def test_host_kernel_legacy_and_fixed_base_match_plain(
        host_lib, models, robot, kind, terrain, fixed, world):
    """The legacy-contact variant (LEG), floating or with a fixed base
    (FIX): the hopper on the plane, on the step grid, and in the walls of
    tests/test_pallas_physics.py's corridor on both; Go1 grounded on the
    plane, floating and fixed; Mini Cheetah in flight and grounded over
    the generated grid, and in the default corridor (flight at 0.75 m,
    inside the walls' height) on the plane and over the grid. Implicit PD
    on."""
    model = models[robot]
    n = 200 if robot == "hopper" else 64
    state, params, tau, imp = physics_inputs(model, n, 13, kind)
    grid, boxes, origins = None, None, None
    if world:
        if robot == "hopper":
            boxes = default_corridor(1.2, 0.5, wall_height=1.0)
            origins = np.zeros((n, 3), np.float32)
        else:
            boxes = default_corridor()
            state, origins = near_walls(state, 20, 0.75 if kind == "flight"
                                        else None)
    if terrain:
        grid = step_grid()[1] if robot == "hopper" else generated_grid()[1]
        if robot != "hopper":
            rel = state["base_pos"][:, :2] - (0 if origins is None
                                              else origins[:, :2])
            state = on_terrain(state, grid, 14)
            if origins is not None:
                origins[:, :2] = state["base_pos"][:, :2] - rel
    state, params, tau, imp = torch_inputs(state, params, tau, imp)
    sim = SimCfg(contact_model="legacy")
    kw = dict(terrain=grid, implicit_damp=imp)
    if world:
        kw.update(world_boxes=boxes, env_origin=torch.tensor(origins))
    ref = physics_step_soa(model, sim, state, tau, params, fixed_base=fixed,
                           **kw)
    out = CP.physics_step_host(host_lib, model, sim, state, tau, params,
                               fixed_base=fixed, **kw)
    if kind != "flight":
        assert ref.contact_report.abs().max() > 1.0
    if fixed:
        assert torch.equal(out.state.base_pos, state.base_pos)
        assert (out.state.base_lin_vel == 0).all()
    if world and kind != "ground":
        assert_step_close_walls(ref, out, wall_depth(
            model, kw["world_boxes"], ref.geom_pos, kw["env_origin"]))
    else:
        assert_step_close(ref, out, kind)


LANE_VARIANTS = {  # terrain, world boxes, legacy contact, fixed base
    "plane": (False, False, False, False),
    "terrain": (True, False, False, False),
    "world": (True, True, False, False),
    "legacy": (True, False, True, False),
    "fixed_base": (True, False, True, True),
    "plane_world": (False, True, False, False),
    "plane_legacy": (False, False, True, False),
    "plane_legacy_fixed_base": (False, False, True, True),
    "plane_world_legacy": (False, True, True, False),
    "plane_world_legacy_fixed_base": (False, True, True, True),
    "world_legacy": (True, True, True, False),
    "world_legacy_fixed_base": (True, True, True, True),
}


@pytest.mark.parametrize("variant", list(LANE_VARIANTS))
@pytest.mark.parametrize("robot,kind", [
    ("hopper", "hopper"), ("go1", "flight"), ("go1", "ground"),
    ("mc", "flight"), ("mc", "ground")])
def test_host_kernel_lane_order_is_bitwise(host_lib, host_lib_reversed,
                                           models, robot, kind, variant):
    """The team body gives the same bits with each phase's lanes run first
    to last and last to first, in every variant the card builds (implicit
    PD on): a phase in which one lane reads what another lane of it writes
    would be a data race on the card, and shows here as a difference. The
    hopper's 1x2 layout on the step grid and in the small corridor; Go1
    and Mini Cheetah over the generated grid and in the default corridor,
    flight inside the walls' height."""
    model = models[robot]
    n = 32 if robot == "hopper" else 16
    terrain, world, legacy, fixed = LANE_VARIANTS[variant]
    state, params, tau, imp = physics_inputs(model, n, 15, kind)
    grid, boxes, origins = None, None, None
    if world:
        if robot == "hopper":
            boxes = default_corridor(1.2, 0.5, wall_height=1.0)
            origins = np.zeros((n, 3), np.float32)
        else:
            boxes = default_corridor()
            state, origins = near_walls(state, 16, 0.75 if kind == "flight"
                                        else None)
    if terrain:
        grid = step_grid()[1] if robot == "hopper" else generated_grid()[1]
        if robot != "hopper":
            rel = state["base_pos"][:, :2] - (0 if origins is None
                                              else origins[:, :2])
            state = on_terrain(state, grid, 17)
            if origins is not None:
                origins[:, :2] = state["base_pos"][:, :2] - rel
    state, params, tau, imp = torch_inputs(state, params, tau, imp)
    sim = SimCfg(contact_model="legacy" if legacy else "apparent")
    kw = dict(implicit_damp=imp, terrain=grid, world_boxes=boxes,
              env_origin=None if origins is None else torch.tensor(origins),
              fixed_base=fixed)
    fwd = CP.physics_step_host(host_lib, model, sim, state, tau, params, **kw)
    rev = CP.physics_step_host(host_lib_reversed, model, sim, state, tau,
                               params, **kw)
    for a, b in zip(list(fwd.state) + [fwd.contact_report, fwd.geom_pos],
                    list(rev.state) + [rev.contact_report, rev.geom_pos]):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)
    if kind != "flight" or world:
        assert fwd.contact_report.abs().max() > 0.0


def test_legacy_constants_in_the_table(models):
    """The header's legacy constants: stiffness, damping, stiffness x
    substep dt (formed in float64) and the friction velocity epsilon."""
    model = models["mc"]
    sim = SimCfg()
    layout = CP.check_supported(model, sim)
    t = CP.pack_constants(model, sim, layout)
    dt = sim.dt / sim.num_substeps
    np.testing.assert_array_equal(t[14:18], np.float32(
        [sim.contact_stiffness, sim.contact_damping,
         sim.contact_stiffness * dt, sim.friction_vel_eps]))


def test_world_table_and_channels(models):
    """The world block of the constant table (count, stiffness, c_n,
    friction, velocity epsilon, then center and half extents per box) and
    the 3 origin rows after the terrain rows: 238 input channels for Mini
    Cheetah on terrain with the corridor."""
    model = models["mc"]
    sim = SimCfg()
    boxes = default_corridor()
    layout = CP.check_supported(model, sim, world_boxes=boxes)
    t = CP.pack_constants(model, sim, layout, boxes, 0.8)
    wo = (CP.HDR + CP.BASE_SIZE + layout.D * layout.K * CP.SLOT
          + model.ng * CP.GEOM)
    dt = sim.dt / sim.num_substeps
    c_n = sim.contact_damping + sim.contact_stiffness * dt
    np.testing.assert_array_equal(t[wo:wo + 5], np.float32(
        [4, sim.contact_stiffness, c_n, 0.8, sim.friction_vel_eps]))
    np.testing.assert_array_equal(
        t[wo + CP.W_HDR:].reshape(4, 6),
        torch.cat([boxes.centers, boxes.half_extents], -1).numpy())
    assert t.size == wo + CP.W_HDR + 4 * CP.W_BOX
    _, grid = step_grid()
    state, params, tau, imp = torch_inputs(*physics_inputs(model, 5, 0,
                                                           "ground"))
    origin = torch.arange(15.0).reshape(5, 3)
    gt = CP.geom_terrain_at(model, sim, layout, state, grid, None)
    x = CP.pack_inputs(model, state, tau, params, imp, grid, gt, origin)
    assert x.shape == (238, 5)
    torch.testing.assert_close(x[235:], origin.T)


def test_constant_table_layout_matches_header():
    """The offsets of ops/cuda_physics.py are the header's RL_* defines."""
    src = open(f"{CP.CSRC_DIR}/substep_chain.cuh").read()
    define = dict(re.findall(r"#define (RL_\w+) (\d+)", src))
    assert int(define["RL_HDR"]) == CP.HDR
    assert int(define["RL_BASE_SIZE"]) == CP.BASE_SIZE
    assert int(define["RL_SLOT"]) == CP.SLOT
    assert int(define["RL_GEOM"]) == CP.GEOM
    assert int(define["RL_W_HDR"]) == CP.W_HDR
    assert int(define["RL_W_BOX"]) == CP.W_BOX
    assert int(define["RL_MAX_NG"]) == CP.MAX_NG
    assert int(define["RL_MAX_NR"]) == CP.MAX_NR


def test_pack_shapes_go1(models):
    """Go1 with implicit PD: 67 input channels, 259 output channels."""
    model = models["go1"]
    state, params, tau, imp = torch_inputs(*physics_inputs(model, 5, 0,
                                                           "ground"))
    assert CP.pack_inputs(model, state, tau, params, imp).shape == (67, 5)
    assert CP.pack_inputs(model, state, tau, params, None).shape == (55, 5)
    assert CP.out_channels(model) == 259


def test_pack_shapes_mini_cheetah_terrain(models):
    """Mini Cheetah on terrain with implicit PD: 67 + 4 ng = 235 input
    channels (heights, then x/y/z normals per geom), 202 output channels;
    the mixed friction takes the grid's static friction."""
    model = models["mc"]
    _, grid = step_grid()
    state, params, tau, imp = torch_inputs(*physics_inputs(model, 5, 0,
                                                           "ground"))
    layout = CP.check_supported(model, SimCfg(), terrain=grid)
    hh, nn = CP.geom_terrain_at(model, SimCfg(), layout, state, grid, None)
    x = CP.pack_inputs(model, state, tau, params, imp, grid, (hh, nn))
    assert x.shape == (235, 5) and CP.out_channels(model) == 202
    c = 13 + 3 * model.nv
    torch.testing.assert_close(x[c + 5], 0.5 * (params.friction
                                                 + grid.static_friction))
    torch.testing.assert_close(x[c + 6 + model.nv:c + 6 + model.nv + 42],
                               hh.T)
    torch.testing.assert_close(x[c + 6 + model.nv + 42 + 3:
                                 c + 6 + model.nv + 42 + 6], nn[:, 1].T)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["flight", "ground"])
def test_cuda_kernel_matches_plain(models, kind):
    """Runs on a machine with a CUDA card (python -m pytest -m gpu)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    model = models["go1"]
    state, params, tau, imp = torch_inputs(
        *physics_inputs(model, 4096, 7, kind))
    state = type(state)(*(t.cuda() for t in state))
    params = type(params)(*(t.cuda() for t in params))
    tau, imp = tau.cuda(), imp.cuda()
    before = CP.KERNEL.launches
    out = CP.physics_step_cuda(model, SimCfg(), state, tau, params,
                               implicit_damp=imp)
    torch.cuda.synchronize()
    assert CP.KERNEL.launches == before + 1
    ref = physics_step_soa(model, SimCfg(), state, tau, params,
                           implicit_damp=imp)
    to_np = lambda o: type(o)(type(o.state)(*(t.cpu() for t in o.state)),  # noqa: E731
                              o.contact_report.cpu(), o.geom_pos.cpu())
    assert_step_close(to_np(ref), to_np(out), kind)


def test_cuda_wrapper_rejects_bad_inputs(models):
    """The checks run before any build or launch."""
    model = models["go1"]
    state, params, tau, imp = torch_inputs(*physics_inputs(model, 4, 0,
                                                           "ground"))
    with pytest.raises(TypeError):
        CP._check_inputs(model, state, tau.double(), params, imp,
                         torch.device("cpu"))
    with pytest.raises(ValueError):
        CP._check_inputs(model, state, tau[:, :5], params, imp,
                         torch.device("cpu"))
    with pytest.raises(ValueError):
        CP._check_inputs(model, state, tau, params, imp,
                         torch.device("cuda"))


def card_table():
    """RL_CARD_VARIANTS of csrc/physics_step.cu, in its order."""
    with open(os.path.join(CP.CSRC_DIR, "physics_step.cu")) as f:
        src = f.read()
    body = src[src.index("#define RL_CARD_VARIANTS(X)"):]
    body = body[:body.index("\n\n")]
    return tuple(tuple(int(v) for v in m) for m in re.findall(
        r"X\((\d+), (\d+), (\d), (\d), (\d), (\d)\)", body))


def test_cuda_variant_table_matches_source():
    """The card's table is RL_CARD_VARIANTS, and it holds every
    combination that the JAX package's kernel takes for both limb layouts
    in the repo: terrain, world boxes and the legacy contact model each on
    or off, a fixed base with the legacy model; the implicit-damping input
    is always given (zeros for none)."""
    assert CP.CUDA_VARIANTS == card_table()
    want = {(D, K, t, w, leg, fix) for (D, K) in ((3, 4), (1, 2))
            for t in (0, 1) for w in (0, 1) for leg in (0, 1)
            for fix in (0, 1) if leg or not fix}
    assert set(CP.CUDA_VARIANTS) == want and len(CP.CUDA_VARIANTS) == 24
    # the lane-order test runs every variant of the quadruped's layout
    assert {(3, 4) + tuple(int(f) for f in v)
            for v in LANE_VARIANTS.values()} == set(CP.CUDA_VARIANTS[:12])
    names = {CP.variant_name(v) for v in CP.CUDA_VARIANTS}
    assert len(names) == 24
    assert CP.variant_name((3, 4, 1, 1, 1, 1)) == \
        "physics_step_terrain_world_legacy_fixed_base"
    assert CP.variant_name((1, 2, 0, 0, 0, 0)) == "physics_step_1x2"


def assert_dispatched_and_cpu_refused(x, y, cst, layout, has_imp, **flags):
    """The combination has an instance in the card's table, and on CPU
    tensors launch_packed refuses only their device: nothing is built,
    launched or counted."""
    assert CP.variant_of(layout, **flags) in card_table()
    k = CP.KERNEL
    before = (k.launches, k.world_launches, k.legacy_launches,
              k.fixed_base_launches, dict(k.variant_launches))
    with pytest.raises(ValueError, match="CUDA tensors"):
        k.launch_packed(x, y, cst, layout, has_imp, **flags)
    assert (k.launches, k.world_launches, k.legacy_launches,
            k.fixed_base_launches, k.variant_launches) == before


@pytest.mark.parametrize("robot,with_imp,with_world", [
    ("hopper", True, False), ("go1", False, False), ("go1", True, True)])
def test_cuda_launch_refuses_variants_not_built(models, robot, with_imp,
                                                with_world):
    """Combinations that earlier builds refused (the hopper's layout, no
    damping input, the walls on the plane) now have an instance: the card
    takes them, and on the CPU only the tensors' device is refused."""
    model = models[robot]
    state, params, tau, imp = torch_inputs(*physics_inputs(model, 4, 0,
                                                           "ground"))
    imp = imp if with_imp else None
    layout = CP.check_supported(model, SimCfg())
    boxes = default_corridor() if with_world else None
    origin = torch.zeros(4, 3) if with_world else None
    x = CP.pack_inputs(model, state, tau, params, imp, env_origin=origin)
    y = torch.empty((CP.out_channels(model), 4))
    cst = torch.from_numpy(CP.pack_constants(model, SimCfg(), layout, boxes))
    assert_dispatched_and_cpu_refused(x, y, cst, layout, with_imp,
                                      has_world=with_world)


@pytest.mark.parametrize("legacy,fixed,terrain,world", [
    (True, False, False, False),
    (False, True, True, False),
    (True, True, False, False),
    (True, False, True, True),
])
def test_cuda_launch_refuses_legacy_and_fixed_base_not_built(
        models, legacy, fixed, terrain, world):
    """The legacy model on the plane, both on the plane, and the legacy
    model with the walls now have an instance (the CPU refuses only the
    device); a fixed base with the apparent model is still refused as a
    bad argument (NaN in the plain version, soa_physics.check_supported),
    and nothing is counted."""
    model = models["mc"]
    layout = CP.check_supported(model, SimCfg())
    x = torch.empty((10, 4))
    y = torch.empty((CP.out_channels(model), 4))
    cst = torch.from_numpy(CP.pack_constants(model, SimCfg(), layout))
    flags = dict(has_terrain=terrain, has_world=world, legacy=legacy,
                 fixed_base=fixed)
    if fixed and not legacy:
        k = CP.KERNEL
        before = (k.launches, k.legacy_launches, k.fixed_base_launches)
        with pytest.raises(ValueError, match="fixed base"):
            k.launch_packed(x, y, cst, layout, True, **flags)
        assert (k.launches, k.legacy_launches,
                k.fixed_base_launches) == before
        assert CP.variant_of(layout, **flags) not in card_table()
    else:
        assert_dispatched_and_cpu_refused(x, y, cst, layout, True, **flags)


@pytest.mark.parametrize("robot,terrain", [
    ("hopper", False), ("hopper", True), ("mc", False), ("mc", True)])
def test_host_kernel_zero_damping_is_bitwise(host_lib, models, robot,
                                             terrain):
    """The card builds every variant with the implicit-damping input only,
    and a caller without one gets zeros: on the g++ build the instance
    without the input (IMP false) and the one with zeros give the same
    bits, for both layouts, on the plane and on terrain."""
    model = models[robot]
    kind = "hopper" if robot == "hopper" else "ground"
    state, params, tau, imp = physics_inputs(model, 64, 18, kind)
    grid = None
    if terrain:
        grid = step_grid()[1] if robot == "hopper" else generated_grid()[1]
        if robot != "hopper":
            state = on_terrain(state, grid, 19)
    state, params, tau, imp = torch_inputs(state, params, tau, imp)
    without = CP.physics_step_host(host_lib, model, SimCfg(), state, tau,
                                   params, terrain=grid)
    zeros = CP.physics_step_host(host_lib, model, SimCfg(), state, tau,
                                 params, terrain=grid,
                                 implicit_damp=torch.zeros_like(tau))
    assert without.contact_report.abs().max() > 0.0
    for a, b in zip(list(without.state) + [without.contact_report,
                                           without.geom_pos],
                    list(zeros.state) + [zeros.contact_report,
                                         zeros.geom_pos]):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)
