"""The port's host-side model code (URDF loading, limb layout, config) is
a copy of the JAX package's: every RobotModel field and the limb layout
must be equal exactly, and configs must round-trip through JSON between
the two packages."""

import dataclasses
import json

import numpy as np
import pytest

from rapid_locomotion_rl_tpu import config as jcfg
from rapid_locomotion_rl_tpu.models import load_urdf as jload_urdf
from rapid_locomotion_rl_tpu.ops.limb_dynamics import layout_for as jlayout
from rapid_locomotion_rl_tpu_torch import config as tcfg
from rapid_locomotion_rl_tpu_torch.models import RobotModel, load_urdf
from rapid_locomotion_rl_tpu_torch.ops.limb_dynamics import layout_for
from torch_port_helpers import GO1, MC, TINY


@pytest.fixture(scope="module")
def urdfs(tmp_path_factory):
    p = tmp_path_factory.mktemp("hopper") / "tiny.urdf"
    p.write_text(TINY)
    return {"go1": GO1, "mini_cheetah": MC, "hopper": str(p)}


@pytest.mark.parametrize("robot", ["go1", "mini_cheetah", "hopper"])
@pytest.mark.parametrize("fit", ["legacy", "hull"])
def test_robot_model_fields_equal(urdfs, robot, fit):
    a = jload_urdf(urdfs[robot], mesh_sphere_fit=fit)
    b = load_urdf(urdfs[robot], mesh_sphere_fit=fit)
    for f in dataclasses.fields(RobotModel):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("robot", ["go1", "mini_cheetah", "hopper"])
def test_limb_layout_equal(urdfs, robot):
    la = jlayout(jload_urdf(urdfs[robot]))
    lb = layout_for(load_urdf(urdfs[robot]))
    assert (la.K, la.D) == (lb.K, lb.D)
    np.testing.assert_array_equal(la.body_index, lb.body_index)
    np.testing.assert_array_equal(la.joint_index, lb.joint_index)


def test_go1_sizes(urdfs):
    m = load_urdf(urdfs["go1"])
    lay = layout_for(m)
    assert (m.nb, m.nv, m.ng, m.nr) == (13, 12, 57, 17)
    assert (lay.D, lay.K) == (3, 4)


@pytest.mark.parametrize("name", ["config_go1", "config_mini_cheetah", None])
def test_config_json_round_trip(name):
    a = getattr(jcfg, name)() if name else jcfg.Cfg()
    b = getattr(tcfg, name)() if name else tcfg.Cfg()
    assert json.loads(a.to_json()) == json.loads(b.to_json())
    # JAX package's JSON -> port config -> JSON, and back
    assert tcfg.Cfg.from_json(a.to_json()).to_dict() == a.to_dict()
    assert jcfg.Cfg.from_json(b.to_json()).to_dict() == b.to_dict()
    assert tcfg.derive(b) == tcfg.Derived(**dataclasses.asdict(
        jcfg.derive(a)))
