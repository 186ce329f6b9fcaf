"""The port's env step with ``sim.physics_impl = "aos"`` (the general
physics step, plain PyTorch) against the JAX env's AoS step, on Mini
Cheetah over a trimesh grid (tests/torch_port_helpers.py::mc_env_step:
64 envs, 2 x 2 cells, decimation 2, the terrain curriculum, time-outs,
teleports and replayed reset draws), on every field that
tests/test_torch_env_trimesh.py checks, at its tolerances; and the
physics selection: ``aos`` takes the general step and no window, a tree
with no limb layout takes ``aos`` with one printed line, ``auto`` on the
CPU stays on the limb-batched step."""

import pytest
import torch

from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
from rapid_locomotion_rl_tpu_torch.envs import legged_robot as TLR
from torch_port_helpers import TINY, assert_env_step_close, mc_env_step


def _aos(c):
    c.sim.physics_impl = "aos"


@pytest.fixture(scope="module")
def aos_step():
    return mc_env_step(_aos)


def test_aos_env_step_matches_jax(aos_step):
    jax_side, port_side = aos_step
    assert port_side[0].physics_impl == "aos"
    assert port_side[0]._window is None
    assert_env_step_close(jax_side, port_side)


def test_aos_env_calls_the_general_step(monkeypatch):
    """Under ``aos`` every physics call goes through ops.physics and none
    through the limb-batched step; under ``auto`` on the CPU the reverse."""
    calls = {"aos": 0, "soa": 0}
    aos, soa = TLR.physics_step, TLR.physics_step_cuda

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(TLR, "physics_step", count("aos", aos))
    monkeypatch.setattr(TLR, "physics_step_cuda", count("soa", soa))
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    for impl in ("aos", "auto"):
        c = config_mini_cheetah()
        c.env.num_envs = 4
        c.terrain.mesh_type = "plane"
        c.sim.physics_impl = impl
        env = TLR.LeggedRobotEnv(c, device="cpu")
        s = Sampler(0, "cpu")
        env.step(env.initial_state(s), torch.zeros(4, 12), s)
    dec = c.control.decimation
    assert calls == {"aos": dec, "soa": dec}


def test_limbless_tree_takes_aos(tmp_path, capsys):
    """A tree that does not decompose into equal limbs (the hopper with a
    third, shorter limb) takes ``aos`` whatever is asked, with one line."""
    from rapid_locomotion_rl_tpu_torch.models import load_urdf
    from rapid_locomotion_rl_tpu_torch.ops.limb_dynamics import layout_for
    extra = """
  <joint name="tail" type="revolute">
    <parent link="legL"/><child link="tail"/>
    <origin xyz="0 0 -0.1"/><axis xyz="0 1 0"/>
    <limit lower="-2" upper="2" effort="20" velocity="20"/>
  </joint>
  <link name="tail">
    <inertial><mass value="0.1"/>
      <inertia ixx="0.0001" iyy="0.0001" izz="0.0001" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
</robot>"""
    path = tmp_path / "limbless.urdf"
    path.write_text(TINY.replace("</robot>", extra))
    assert layout_for(load_urdf(str(path))) is None

    class Stub:
        cfg = config_mini_cheetah()
        model = load_urdf(str(path))
    for impl in ("auto", "soa", "pallas", "aos"):
        Stub.cfg.sim.physics_impl = impl
        assert TLR.LeggedRobotEnv._physics_impl(Stub()) == "aos"
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 3 and all("no limb layout" in line for line in out)
    Stub.cfg.sim.physics_impl = "gpu"
    with pytest.raises(ValueError, match="physics_impl"):
        TLR.LeggedRobotEnv._physics_impl(Stub())
