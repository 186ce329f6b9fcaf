"""The port's plain physics step (rapid_locomotion_rl_tpu_torch.ops.soa_physics)
against the JAX package's SoA step and its Pallas kernel (interpret mode),
on the plane and on terrain grids.

Both sides get the same numpy inputs. Identical arithmetic in float32
agrees to the tolerances of tests/test_pallas_physics.py (2e-5 on state,
2e-4/2e-3 on contact reports, 1e-5 on geom positions); grounded Go1 and
Mini Cheetah states with random torques agree by the bulk rule of
tests/test_soa_physics.py. On terrain the JAX side reads the geoms' cells
through its patch einsums and the port through 4-corner gathers, which
agree up to float reassociation (tests/test_torch_terrain.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu.config import SimCfg as JSimCfg
from rapid_locomotion_rl_tpu.models import load_urdf as jload_urdf
from rapid_locomotion_rl_tpu.ops.dynamics import PhysParams as JParams
from rapid_locomotion_rl_tpu.ops.dynamics import SimState as JState
from rapid_locomotion_rl_tpu.ops.pallas_physics import physics_step_pallas
from rapid_locomotion_rl_tpu.ops.soa_physics import physics_step_soa as jstep
from rapid_locomotion_rl_tpu_torch.config import SimCfg
from rapid_locomotion_rl_tpu_torch.models import load_urdf
from rapid_locomotion_rl_tpu_torch.ops.cuda_physics import physics_step_cuda
from rapid_locomotion_rl_tpu_torch.ops.soa_physics import (fk_geom_xy,
                                                           physics_step_soa)
from torch_port_helpers import (GO1, MC, TINY, assert_step_close,
                                generated_grid, on_terrain, physics_inputs,
                                step_grid, torch_inputs)


@pytest.fixture(scope="module")
def hopper_urdf(tmp_path_factory):
    p = tmp_path_factory.mktemp("hopper") / "tiny.urdf"
    p.write_text(TINY)
    return str(p)


def _jax_inputs(state, params, tau, imp):
    return (JState(**{k: jnp.asarray(v) for k, v in state.items()}),
            JParams(**{k: jnp.asarray(v) for k, v in params.items()}),
            jnp.asarray(tau), None if imp is None else jnp.asarray(imp))


@pytest.mark.parametrize("n", [77, 200])
@pytest.mark.parametrize("with_imp", [False, True])
def test_hopper_matches_jax_soa(hopper_urdf, n, with_imp):
    jm, tm = jload_urdf(hopper_urdf), load_urdf(hopper_urdf)
    state, params, tau, imp = physics_inputs(tm, n, 0, "hopper")
    imp = imp if with_imp else None
    js, jp, jt, ji = _jax_inputs(state, params, tau, imp)
    with jax.disable_jit():
        ref = jstep(jm, JSimCfg(), js, jt, jp, None, implicit_damp=ji)
    ts, tp, tt, ti = torch_inputs(state, params, tau, imp)
    out = physics_step_soa(tm, SimCfg(), ts, tt, tp, implicit_damp=ti)
    assert np.abs(np.asarray(ref.contact_report)).max() > 0.0, \
        "the hopper case should have contacts"
    assert_step_close(ref, out, "strict")


@pytest.mark.parametrize("n,with_imp", [(77, True), (200, False)])
def test_hopper_matches_jax_pallas_kernel(hopper_urdf, n, with_imp):
    """Against the TPU kernel itself (interpret mode): both env counts are
    off the kernel's 1024-env block, and both implicit-PD variants appear.
    Interpret mode takes ~10 s a case here, so the other two combinations
    go through the SoA step only, which tests/test_pallas_physics.py holds
    to the kernel."""
    jm, tm = jload_urdf(hopper_urdf), load_urdf(hopper_urdf)
    state, params, tau, imp = physics_inputs(tm, n, 0, "hopper")
    imp = imp if with_imp else None
    js, jp, jt, ji = _jax_inputs(state, params, tau, imp)
    with jax.disable_jit():
        ref = physics_step_pallas(jm, JSimCfg(), js, jt, jp, None,
                                  implicit_damp=ji, interpret=True)
    ts, tp, tt, ti = torch_inputs(state, params, tau, imp)
    out = physics_step_soa(tm, SimCfg(), ts, tt, tp, implicit_damp=ti)
    assert_step_close(ref, out, "strict")


@pytest.fixture(scope="module")
def go1_pair():
    """One JAX call on 16 Go1 envs (implicit PD on): envs 0-7 in torque-free
    flight, envs 8-15 grounded with random torques."""
    jm, tm = jload_urdf(GO1), load_urdf(GO1)
    fl = physics_inputs(tm, 8, 3, "flight")
    gr = physics_inputs(tm, 8, 3, "ground")
    state = {k: np.concatenate([fl[0][k], gr[0][k]]) for k in fl[0]}
    params = {k: np.concatenate([fl[1][k], gr[1][k]]) for k in fl[1]}
    tau, imp = np.concatenate([fl[2], gr[2]]), np.concatenate([fl[3], gr[3]])
    js, jp, jt, ji = _jax_inputs(state, params, tau, imp)
    with jax.disable_jit():
        ref = jstep(jm, JSimCfg(), js, jt, jp, None, implicit_damp=ji)
    ts, tp, tt, ti = torch_inputs(state, params, tau, imp)
    out = physics_step_soa(tm, SimCfg(), ts, tt, tp, implicit_damp=ti)
    return ref, out


def _half(o, sl):
    return type(o)(type(o.state)(*(np.asarray(x)[sl] for x in o.state)),
                   np.asarray(o.contact_report)[sl],
                   np.asarray(o.geom_pos)[sl])


@pytest.mark.parametrize("kind", ["flight", "ground"])
def test_go1_matches_jax_soa(go1_pair, kind):
    """Go1 (nb=13, nv=12, ng=57, nr=17): torque-free flight strictly,
    grounded random-torque states in bulk."""
    sl = slice(0, 8) if kind == "flight" else slice(8, 16)
    ref, out = (_half(o, sl) for o in go1_pair)
    if kind == "ground":
        assert np.abs(ref.contact_report).max() > 1.0
    else:
        assert np.abs(ref.contact_report).max() == 0.0
    assert_step_close(ref, out, kind)


def test_fk_geom_xy_matches_jax():
    from rapid_locomotion_rl_tpu.ops.limb_dynamics import layout_for as jlay
    from rapid_locomotion_rl_tpu.ops.soa_physics import fk_geom_xy as jfk
    from rapid_locomotion_rl_tpu_torch.ops.limb_dynamics import layout_for
    jm, tm = jload_urdf(GO1), load_urdf(GO1)
    state, _, _, _ = physics_inputs(tm, 8, 5, "ground")
    pos, quat, q = state["base_pos"], state["base_quat"], state["q"]
    ref = jfk(jm, jlay(jm), [jnp.asarray(pos[:, i]) for i in range(3)],
              [jnp.asarray(quat[:, i]) for i in range(4)],
              [jnp.asarray(q[:, j]) for j in range(12)])
    out = fk_geom_xy(tm, layout_for(tm),
                     [torch.tensor(pos[:, i]) for i in range(3)],
                     [torch.tensor(quat[:, i]) for i in range(4)],
                     [torch.tensor(q[:, j]) for j in range(12)])
    assert len(out) == tm.ng
    for (rx, ry), (ox, oy) in zip(ref, out):
        np.testing.assert_allclose(ox.numpy(), np.asarray(rx), atol=1e-6)
        np.testing.assert_allclose(oy.numpy(), np.asarray(ry), atol=1e-6)


def test_cpu_dispatch_runs_plain_version(hopper_urdf):
    """physics_step_cuda on CPU tensors is the plain version, exactly."""
    tm = load_urdf(hopper_urdf)
    ts, tp, tt, ti = torch_inputs(*physics_inputs(tm, 33, 4, "hopper"))
    a = physics_step_cuda(tm, SimCfg(), ts, tt, tp, implicit_damp=ti)
    b = physics_step_soa(tm, SimCfg(), ts, tt, tp, implicit_damp=ti)
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
    assert torch.equal(a.contact_report, b.contact_report)


@pytest.mark.parametrize("reference", ["soa", "pallas"])
def test_hopper_on_step_grid_matches_jax(hopper_urdf, reference):
    """Terrain input on the step grid of tests/test_pallas_physics.py
    (heights 0 and 0.08 m, the step's normals), implicit PD on, 200 envs:
    against the JAX SoA step and the TPU kernel's terrain variant in
    interpret mode. The default terrain_patch_size of 16 makes both sides
    look up through the per-call square window."""
    jm, tm = jload_urdf(hopper_urdf), load_urdf(hopper_urdf)
    jg, tg = step_grid()
    state, params, tau, imp = physics_inputs(tm, 200, 0, "hopper")
    js, jp, jt, ji = _jax_inputs(state, params, tau, imp)
    with jax.disable_jit():
        if reference == "soa":
            ref = jstep(jm, JSimCfg(), js, jt, jp, jg, implicit_damp=ji)
        else:
            ref = physics_step_pallas(jm, JSimCfg(), js, jt, jp, jg,
                                      implicit_damp=ji, interpret=True)
    ts, tp, tt, ti = torch_inputs(state, params, tau, imp)
    out = physics_step_soa(tm, SimCfg(), ts, tt, tp, terrain=tg,
                           implicit_damp=ti)
    gx = np.asarray(ref.geom_pos)[..., 0]
    assert (gx > 0.45).any() and (gx < 0.35).any(), \
        "geoms should sit on both sides of the step"
    assert np.abs(np.asarray(ref.contact_report)).max() > 0.0
    assert_step_close(ref, out, "strict")


@pytest.fixture(scope="module")
def mc_terrain_pair():
    """One JAX call on 16 Mini Cheetah envs over the generated grid
    (slopes, stairs, obstacles; implicit PD on): envs 0-7 in torque-free
    flight, envs 8-15 standing on the terrain with random torques."""
    jm, tm = jload_urdf(MC), load_urdf(MC)
    jg, tg = generated_grid()
    fl = physics_inputs(tm, 8, 11, "flight")
    gr = physics_inputs(tm, 8, 12, "ground")
    st = {k: np.concatenate([fl[0][k], gr[0][k]]) for k in fl[0]}
    st = on_terrain(st, tg, 13)
    params = {k: np.concatenate([fl[1][k], gr[1][k]]) for k in fl[1]}
    tau, imp = np.concatenate([fl[2], gr[2]]), np.concatenate([fl[3], gr[3]])
    js, jp, jt, ji = _jax_inputs(st, params, tau, imp)
    with jax.disable_jit():
        ref = jstep(jm, JSimCfg(), js, jt, jp, jg, implicit_damp=ji)
    ts, tp, tt, ti = torch_inputs(st, params, tau, imp)
    out = physics_step_soa(tm, SimCfg(), ts, tt, tp, terrain=tg,
                           implicit_damp=ti)
    return ref, out, tg, ts


@pytest.mark.parametrize("kind", ["flight", "ground"])
def test_mini_cheetah_on_terrain_matches_jax(mc_terrain_pair, kind):
    """Mini Cheetah (nv=12, ng=42, nr=13): flight strictly, grounded
    states on non-flat cells in bulk."""
    ref, out, tg, ts = mc_terrain_pair
    sl = slice(0, 8) if kind == "flight" else slice(8, 16)
    ref, out = (_half(o, sl) for o in (ref, out))
    if kind == "ground":
        from rapid_locomotion_rl_tpu_torch.ops.contact import \
            terrain_height_and_normal
        gp = torch.tensor(ref.geom_pos)
        _, n = terrain_height_and_normal(tg, gp[..., 0], gp[..., 1])
        assert (n[..., 2] < 0.999).any(), "no geom over a sloped cell"
        assert np.abs(ref.contact_report).max() > 1.0
    else:
        assert np.abs(ref.contact_report).max() == 0.0
    assert_step_close(ref, out, kind)
