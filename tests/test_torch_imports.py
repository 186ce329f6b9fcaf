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
# the ranks of the data-parallel tests run it alone, with the port only
WORKER = os.path.join(RLTPU_ROOT_DIR, "tests", "torch_dist_worker.py")

SCRIPTS = [os.path.join(RLTPU_ROOT_DIR, "scripts", f)
           for f in sorted(os.listdir(os.path.join(RLTPU_ROOT_DIR,
                                                   "scripts")))
           if f.startswith("torch_") or f.endswith("_cuda.py")]

PROBE = r"""
import importlib.util
import os
import sys
import chip_smoke
import rapid_locomotion_rl_tpu_torch
from rapid_locomotion_rl_tpu_torch import config, convert, sampler
from rapid_locomotion_rl_tpu_torch.envs import (curriculum, hlp,
    legged_robot, rewards, terrain, terrain_native, vec_env, world)
from rapid_locomotion_rl_tpu_torch.learn import (caches, dr_eval, metrics,
    ppo, runner, trajectories)
from rapid_locomotion_rl_tpu_torch.models import (mjcf, networks,
    robot_model, urdf)
from rapid_locomotion_rl_tpu_torch.ops import (contact, cuda_physics,
    dynamics, limb_dynamics, physics, quat, soa, soa_physics, spatial,
    world)
from rapid_locomotion_rl_tpu_torch.parallel import sharding
from rapid_locomotion_rl_tpu_torch.utils import (checkpoint, debug, logger,
    raster, render)
for name in sorted(os.listdir("scripts")):
    if name.endswith("_cuda.py"):
        spec = importlib.util.spec_from_file_location(
            name[:-3], os.path.join("scripts", name))
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        print("SCRIPT", name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "optax", "rapid_locomotion_rl_tpu")
             or m.startswith(("jax.", "jaxlib", "flax.", "optax.",
                              "rapid_locomotion_rl_tpu.")))
print("BAD", bad)
"""


def test_every_port_module_is_probed():
    """PROBE imports every module of the package (``parallel/`` too)."""
    mods = {os.path.splitext(f)[0] for d, _, fs in os.walk(PORT)
            for f in fs if f.endswith(".py") and f != "__init__.py"}
    names = set(re.findall(r"\b\w+\b", PROBE))
    assert mods <= names, sorted(mods - names)


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=RLTPU_ROOT_DIR)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=RLTPU_ROOT_DIR,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    for name in ("eval_sweep_cuda.py", "high_level_play_cuda.py",
                 "hlp_play_cuda.py", "play_cuda.py", "test_cuda.py",
                 "train_cuda.py", "tune_trot_cuda.py",
                 "exp_drift_ab_cuda.py", "exp_drift_sweep_cuda.py",
                 "diag_survival_cuda.py", "diag_contact_cuda.py",
                 "exp_direction_probe_cuda.py", "sim2sim_cuda.py",
                 "diag_propulsion_cuda.py", "diag_hlp_cuda.py",
                 "diag_hlp_rollout_cuda.py", "exp_tracking_only_cuda.py",
                 "bench_terrain_cuda.py", "profile_rollout_cuda.py"):
        assert f"SCRIPT {name}" in out.stdout, name


def test_no_jax_import_lines():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|"
                     r"rapid_locomotion_rl_tpu)(\.|\s|$)")
    files = [SMOKE, WORKER] + SCRIPTS + [os.path.join(d, f)
                                 for d, _, fs in os.walk(PORT)
                                 for f in fs if f.endswith(".py")]
    hits = [f"{p}:{i}: {line.rstrip()}" for p in files
            for i, line in enumerate(open(p), 1) if pat.match(line)]
    assert not hits, hits


def test_ops_import_nothing_of_envs():
    """The physics layer sits below the env: no module of ``ops/`` imports
    from ``envs/`` (the world boxes live in ``ops/world.py``)."""
    pat = re.compile(r"^\s*(from|import)\s+(\.\.envs|rapid_locomotion_rl_tpu"
                     r"_torch\.envs)(\.|\s|$)")
    ops = os.path.join(PORT, "ops")
    hits = [f"{f}:{i}: {line.rstrip()}" for f in sorted(os.listdir(ops))
            if f.endswith(".py")
            for i, line in enumerate(open(os.path.join(ops, f)), 1)
            if pat.match(line)]
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
