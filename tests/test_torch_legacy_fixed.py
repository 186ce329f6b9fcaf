"""The port's plain physics step with the legacy contact model and with a
fixed base (rapid_locomotion_rl_tpu_torch.ops.soa_physics) against the JAX
package's SoA step and its Pallas kernel (interpret mode).

Both sides get the same numpy inputs, at the tolerances of
tests/test_pallas_physics.py (2e-5 on state, 2e-4/2e-3 on contact
reports, 1e-5 on geom positions) and, for grounded Mini Cheetah states
with random torques, the bulk rule of tests/test_soa_physics.py. A fixed
base is held with the legacy contact model: with the apparent model the
inverse apparent inertia of the base's and the hips' spheres is singular,
the JAX package's SoA step returns NaN, and the port refuses the pair
(last test)."""

import functools

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
from rapid_locomotion_rl_tpu_torch.ops.cuda_physics import (
    physics_step_cuda, physics_step_host)
from rapid_locomotion_rl_tpu_torch.ops.soa_physics import physics_step_soa
from torch_port_helpers import (MC, TINY, assert_step_close, generated_grid,
                                on_terrain, physics_inputs, step_grid,
                                torch_inputs)

LEGACY = dict(contact_model="legacy")


@pytest.fixture(scope="module")
def hopper(tmp_path_factory):
    p = tmp_path_factory.mktemp("hopper") / "tiny.urdf"
    p.write_text(TINY)
    return jload_urdf(str(p)), load_urdf(str(p))


def _jax(state, params, tau, imp):
    return (JState(**{k: jnp.asarray(v) for k, v in state.items()}),
            JParams(**{k: jnp.asarray(v) for k, v in params.items()}),
            jnp.asarray(tau), None if imp is None else jnp.asarray(imp))


def _both(jm, tm, inputs, fixed, reference="soa", grids=(None, None),
          sim=LEGACY):
    """One JAX call (eager) and one port call on the same inputs."""
    js, jp, jt, ji = _jax(*inputs)
    with jax.disable_jit():
        if reference == "soa":
            ref = jstep(jm, JSimCfg(**sim), js, jt, jp, grids[0],
                        fixed_base=fixed, implicit_damp=ji)
        else:
            ref = physics_step_pallas(jm, JSimCfg(**sim), js, jt, jp,
                                      grids[0], fixed_base=fixed,
                                      implicit_damp=ji, interpret=True)
    ts, tp, tt, ti = torch_inputs(*inputs)
    out = physics_step_soa(tm, SimCfg(**sim), ts, tt, tp, terrain=grids[1],
                           fixed_base=fixed, implicit_damp=ti)
    return ref, out


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("with_imp", [False, True])
def test_hopper_legacy_on_plane_matches_jax_soa(hopper, fixed, with_imp):
    jm, tm = hopper
    state, params, tau, imp = physics_inputs(tm, 200, 0, "hopper")
    ref, out = _both(jm, tm, (state, params, tau, imp if with_imp else None),
                     fixed)
    assert np.abs(np.asarray(ref.contact_report)).max() > 1.0
    assert_step_close(ref, out, "strict")


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("reference", ["soa", "pallas"])
def test_hopper_legacy_on_step_grid_matches_jax(hopper, reference, fixed):
    """Over the step grid of tests/test_pallas_physics.py (the normals of
    the step's edge are not +z), implicit PD on, 77 envs (off the TPU
    kernel's 1024-env block): against the SoA step and the TPU kernel's
    legacy and fixed-base branches in interpret mode."""
    jm, tm = hopper
    inputs = physics_inputs(tm, 77, 1, "hopper")
    ref, out = _both(jm, tm, inputs, fixed, reference, step_grid())
    gx = np.asarray(ref.geom_pos)[..., 0]
    assert (gx > 0.45).any() and (gx < 0.35).any()
    assert np.abs(np.asarray(ref.contact_report)).max() > 1.0
    assert_step_close(ref, out, "strict")


def test_fixed_base_pins_the_base(hopper):
    """The base keeps its pose exactly and its velocities are zero; the
    joints move."""
    _, tm = hopper
    ts, tp, tt, ti = torch_inputs(*physics_inputs(tm, 50, 2, "hopper"))
    out = physics_step_soa(tm, SimCfg(**LEGACY), ts, tt, tp,
                           fixed_base=True, implicit_damp=ti)
    assert torch.equal(out.state.base_pos, ts.base_pos)
    assert torch.equal(out.state.base_quat, ts.base_quat)
    assert (out.state.base_lin_vel == 0).all()
    assert (out.state.base_ang_vel == 0).all()
    assert (out.state.q != ts.q).any()


@pytest.fixture(scope="module", params=[False, True],
                ids=["floating", "fixed"])
def mc_pair(request):
    """One JAX call on 16 Mini Cheetah envs with the legacy contact model
    over the generated grid (slopes, stairs, obstacles; implicit PD on):
    envs 0-7 in torque-free flight, envs 8-15 standing on the terrain with
    random torques; the base floating or fixed."""
    jm, tm = jload_urdf(MC), load_urdf(MC)
    grids = generated_grid()
    fl = physics_inputs(tm, 8, 21, "flight")
    gr = physics_inputs(tm, 8, 22, "ground")
    st = {k: np.concatenate([fl[0][k], gr[0][k]]) for k in fl[0]}
    st = on_terrain(st, grids[1], 23)
    params = {k: np.concatenate([fl[1][k], gr[1][k]]) for k in fl[1]}
    tau, imp = np.concatenate([fl[2], gr[2]]), np.concatenate([fl[3], gr[3]])
    return _both(jm, tm, (st, params, tau, imp), request.param, "soa", grids)


def _half(o, sl):
    return type(o)(type(o.state)(*(np.asarray(x)[sl] for x in o.state)),
                   np.asarray(o.contact_report)[sl],
                   np.asarray(o.geom_pos)[sl])


@pytest.mark.parametrize("kind", ["flight", "ground"])
def test_mini_cheetah_legacy_on_terrain_matches_jax(mc_pair, kind):
    """Mini Cheetah (nv=12, ng=42, nr=13): flight strictly, grounded
    states on the generated grid in bulk."""
    sl = slice(0, 8) if kind == "flight" else slice(8, 16)
    ref, out = (_half(o, sl) for o in mc_pair)
    if kind == "ground":
        assert np.abs(ref.contact_report).max() > 1.0
    else:
        assert np.abs(ref.contact_report).max() == 0.0
    assert_step_close(ref, out, kind)


def test_cpu_dispatch_takes_the_switches(hopper):
    """physics_step_cuda on CPU tensors is the plain version, exactly, with
    the legacy model and a fixed base passed through."""
    _, tm = hopper
    ts, tp, tt, ti = torch_inputs(*physics_inputs(tm, 33, 4, "hopper"))
    a = physics_step_cuda(tm, SimCfg(**LEGACY), ts, tt, tp,
                          fixed_base=True, implicit_damp=ti)
    b = physics_step_soa(tm, SimCfg(**LEGACY), ts, tt, tp, fixed_base=True,
                         implicit_damp=ti)
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
    assert torch.equal(a.contact_report, b.contact_report)


def test_fixed_base_with_apparent_contact_is_refused(hopper):
    """A fixed base under the apparent contact model: the base's mobility
    is zero, so the inverse apparent inertia of the spheres on the base
    (and, rank 1, on the hips) is singular, and the JAX package's SoA step
    returns NaN in every env, even in the air. The port refuses the pair
    with a ValueError on the CPU path, in the plain step, its CPU dispatch
    and the g++ build's entry alike, before any arithmetic."""
    jm, tm = hopper
    inputs = physics_inputs(tm, 16, 5, "hopper")
    js, jp, jt, ji = _jax(*inputs)
    with jax.disable_jit():
        ref = jstep(jm, JSimCfg(), js, jt, jp, None, fixed_base=True,
                    implicit_damp=ji)
    assert not np.isfinite(np.asarray(ref.contact_report)).all((1, 2)).any()
    ts, tp, tt, ti = torch_inputs(*inputs)
    for step in (physics_step_soa, physics_step_cuda,
                 functools.partial(physics_step_host, None)):
        with pytest.raises(ValueError, match="contact_model='legacy'"):
            step(tm, SimCfg(), ts, tt, tp, fixed_base=True,
                 implicit_damp=ti)
