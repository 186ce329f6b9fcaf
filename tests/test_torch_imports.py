"""The port imports torch and numpy, never JAX or the JAX package; and
chip_smoke.py refuses to run without a CUDA card or outside the repo."""

import os
import re
import shutil
import subprocess
import sys

from rapid_locomotion_rl_tpu import RLTPU_ROOT_DIR

PORT = os.path.join(RLTPU_ROOT_DIR, "rapid_locomotion_rl_tpu_torch")
SMOKE = os.path.join(RLTPU_ROOT_DIR, "chip_smoke.py")

PROBE = r"""
import sys
import chip_smoke
import rapid_locomotion_rl_tpu_torch
from rapid_locomotion_rl_tpu_torch import config, convert, sampler
from rapid_locomotion_rl_tpu_torch.envs import (curriculum, legged_robot,
    rewards, terrain)
from rapid_locomotion_rl_tpu_torch.learn import ppo
from rapid_locomotion_rl_tpu_torch.models import networks, robot_model, urdf
from rapid_locomotion_rl_tpu_torch.ops import (contact, cuda_physics,
    dynamics, limb_dynamics, physics, quat, soa, soa_physics)
from rapid_locomotion_rl_tpu_torch.utils import checkpoint
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "optax", "rapid_locomotion_rl_tpu")
             or m.startswith(("jax.", "jaxlib", "flax.", "optax.",
                              "rapid_locomotion_rl_tpu.")))
print("BAD", bad)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=RLTPU_ROOT_DIR)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=RLTPU_ROOT_DIR,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_no_jax_import_lines():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|"
                     r"rapid_locomotion_rl_tpu)(\.|\s|$)")
    files = [SMOKE] + [os.path.join(d, f) for d, _, fs in os.walk(PORT)
                       for f in fs if f.endswith(".py")]
    hits = [f"{p}:{i}: {line.rstrip()}" for p in files
            for i, line in enumerate(open(p), 1) if pat.match(line)]
    assert not hits, hits


def test_chip_smoke_fails_alone_and_without_card(tmp_path):
    """Copied into an empty directory it cannot import the port; here it
    also has no card. Either way it exits non-zero with no result line."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
