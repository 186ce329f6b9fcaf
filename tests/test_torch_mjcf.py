"""MJCF assets in the port: ``models/mjcf.py::load_mjcf`` against the JAX
package's on resources/robots/go1/xml/go1.xml (every RobotModel field
equal), the ``.xml`` env built as the JAX env builds it (its body groups)
and stepped on the CPU on both physics routes, and the kernel body built
with g++ against the plain step on the MJCF model (38 spheres, 13 report
bodies, a velocity limit of 100 rad/s on every joint), at the tolerances
of tests/test_torch_kernel_host.py."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu import RLTPU_ROOT_DIR
from rapid_locomotion_rl_tpu.models.mjcf import load_mjcf as jload_mjcf
from rapid_locomotion_rl_tpu_torch import config as tcfg
from rapid_locomotion_rl_tpu_torch.config import SimCfg
from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
from rapid_locomotion_rl_tpu_torch.models import load_mjcf
from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
from rapid_locomotion_rl_tpu_torch.ops.soa_physics import physics_step_soa
from rapid_locomotion_rl_tpu_torch.sampler import Sampler
from torch_port_helpers import assert_step_close, physics_inputs, torch_inputs

XML = f"{RLTPU_ROOT_DIR}/resources/robots/go1/xml/go1.xml"
ASSET = "{ROOT}/resources/robots/go1/xml/go1.xml"


@pytest.mark.parametrize("armature", [None, 0.01])
def test_load_mjcf_matches_jax(armature):
    ref = jload_mjcf(XML, armature=armature)
    got = load_mjcf(XML, armature=armature)
    assert (got.nb, got.ng, got.nr, got.nv) == (13, 38, 13, 12)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    np.testing.assert_array_equal(got.dof_velocity, 100.0)


def _go1_xml(mod, n=16):
    c = mod.config_go1()
    c.asset.file = ASSET
    c.env.num_envs = n
    return c


def test_xml_env_body_groups_match_jax():
    from rapid_locomotion_rl_tpu import config as jcfg
    from rapid_locomotion_rl_tpu.envs.legged_robot import \
        LeggedRobotEnv as JEnv
    jenv = JEnv(_go1_xml(jcfg))
    tenv = LeggedRobotEnv(_go1_xml(tcfg), device="cpu")
    for name in ("feet_indices", "termination_contact_indices",
                 "penalised_contact_indices", "num_feet"):
        assert getattr(tenv, name) == getattr(jenv, name), name
    for name in ("default_dof_pos", "p_gains", "d_gains", "torque_limits",
                 "dof_vel_limits", "dof_pos_limits", "noise_scale_vec"):
        np.testing.assert_array_equal(getattr(tenv, name).numpy(),
                                      np.asarray(getattr(jenv, name)),
                                      err_msg=name)


@pytest.mark.parametrize("impl", ["auto", "aos"])
def test_xml_env_steps_on_the_cpu(impl):
    c = _go1_xml(tcfg)
    c.sim.physics_impl = impl
    env = LeggedRobotEnv(c, device="cpu")
    assert env.model.ng == 38 and env.physics_impl == (
        "aos" if impl == "aos" else "soa")
    s = Sampler(0, "cpu")
    state = env.initial_state(s)
    for _ in range(6):     # the feet reach the ground by the 6th step
        state, res = env.step(state, torch.zeros(16, env.num_actions), s)
    assert res.obs.shape == (16, env.num_obs)
    for v in (res.obs, res.rew, *state.sim):
        assert torch.isfinite(v).all()
    assert state.contact_report.abs().max() > 1.0


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to build the kernel body")
    path = CP.build_host_library(str(tmp_path_factory.mktemp("hostlib")))
    return CP.load_host_library(path)


@pytest.mark.parametrize("kind", ["flight", "ground"])
def test_host_kernel_matches_plain_on_mjcf(host_lib, kind):
    model = load_mjcf(XML)
    state, params, tau, imp = torch_inputs(*physics_inputs(model, 64, 7,
                                                           kind))
    ref = physics_step_soa(model, SimCfg(), state, tau, params,
                           implicit_damp=imp)
    out = CP.physics_step_host(host_lib, model, SimCfg(), state, tau, params,
                               implicit_damp=imp)
    if kind == "ground":
        assert ref.contact_report.abs().max() > 0.0
    assert_step_close(ref, out, kind)
