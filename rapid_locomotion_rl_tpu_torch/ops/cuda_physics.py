"""The physics step as one hand-written CUDA kernel, and its wrapper.

:func:`physics_step_cuda` has the signature and :class:`StepOutput` of the
plain :func:`.soa_physics.physics_step_soa`. For tensors on the card it
launches the kernel of ``csrc/physics_step.cu`` (one warp per env, its lanes
splitting the whole control-step call of ``csrc/substep_chain.cuh`` by limb
chain, geom and body, in the plain version's order of sums); for tensors on
the CPU it runs the plain version. It replaces the JAX package's
Pallas kernel ``ops/pallas_physics.py::_kernel``.

Every variant of the JAX package's kernel is built for the card
(:data:`CUDA_VARIANTS`), each its own small library, by ``nvcc`` into
``build/torch_kernels/<hash of csrc/>/`` at its first launch (or all at
once, in parallel, by :meth:`PhysicsStepKernel.build_all`) and loaded with
``ctypes``: the sources have a plain C interface and include no PyTorch
header, so a build takes seconds. The variants cover both limb layouts
in the repo (the quadruped's 3 x 4, the test hopper's 1 x 2): on the plane
or terrain,
with or without the world boxes of the HLP corridor, with the apparent or
the legacy contact model (``SimCfg.contact_model``), and with the legacy
model also a fixed base (``AssetCfg.fix_base_link``; a fixed base under
the apparent model is refused on every device by
:func:`.soa_physics.check_supported`). Every instance takes the
implicit-damping input; a caller without one gets zeros, which give the
bits of the instance without it. The same per-env body also builds
with ``g++`` into a CPU library, in every variant
(:func:`build_host_library`, each phase's lanes run one after another),
which the CPU tests hold against the plain version.

Layout: the wrapper packs the inputs into one [C_in, N] float32 array,
channel-major (state 13+2nv, tau nv, payload 1, CoM shift 3, restitution 1,
mixed friction 1, then implicit damping nv when given, then with terrain
the height under each geom ng and its normal 3ng, then with world boxes
the env origin 3), and unpacks the [13+2nv+3nr+3ng, N] output. The
robot model, the solver constants and the world boxes are a flat float32
table packed once per (model, sim config, boxes, device) by
:func:`pack_constants`.

The terrain rows are the height and unit normal under every geom at the
call's entry state, which the JAX package samples outside its kernel
(``ops/soa_physics.py::_sample_geom_terrain``, inside
``physics_step_pallas``). On the card a second hand-written kernel,
``csrc/geom_terrain.cu`` (a thread per env and geom: FK along the geom's
limb chain from the same constant table, then the windowed bilinear
lookup), writes them straight into the packed input
(:meth:`PhysicsStepKernel.launch_geom_terrain`, its own library built the
same way); its plain version is :func:`.soa_physics.sample_geom_terrain`
(:func:`geom_terrain_at`), which the CPU path, the tests and the smoke
run's holds use, and :func:`build_geom_terrain_host_library` builds its
body with ``g++`` for the CPU tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import ROOT_DIR
from .dynamics import PhysParams, SimState
from .limb_dynamics import LimbLayout, np_spatial_inertia
from .world import WorldBoxes
from .contact import TerrainGrid, Window
from .physics import StepOutput
from .soa_physics import (FIXED_BASE_APPARENT, _v3, check_supported,
                          lookup_window, physics_step_soa,
                          sample_geom_terrain, static_friction)

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
SOURCES = ("substep_chain.cuh", "physics_step.cu", "physics_step_host.cpp",
           "geom_terrain.cuh", "geom_terrain.cu", "geom_terrain_host.cpp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
              "-Wno-unknown-pragmas")

# constant-table layout; mirrors the RL_* offsets of csrc/substep_chain.cuh
HDR = 24
BASE_SIZE = 12
SLOT = 66
GEOM = 8
W_HDR = 8
W_BOX = 6
MAX_NG = 64
MAX_NR = 32
LAYOUTS = ((3, 4), (1, 2))   # (D, K) instantiated in both sources
# the card's variants (D, K, terrain, world boxes, legacy contact, fixed
# base), each with the implicit-damping input; the order of
# csrc/physics_step.cu's RL_CARD_VARIANTS
CUDA_VARIANTS = tuple((D, K, ter, wld, leg, fix) for (D, K) in LAYOUTS
                      for ter in (0, 1) for wld in (0, 1)
                      for (leg, fix) in ((0, 0), (1, 0), (1, 1)))
Variant = Tuple[int, int, int, int, int, int]


def variant_of(layout: LimbLayout, has_terrain=False, has_world=False,
               legacy=False, fixed_base=False) -> Variant:
    return (layout.D, layout.K, int(has_terrain), int(has_world),
            int(legacy), int(fixed_base))


def variant_name(v: Variant) -> str:
    """``physics_step`` plus the layout when it is not 3 x 4 and each
    switch that is on: ``physics_step_terrain_world_legacy``,
    ``physics_step_1x2_fixed_base``..."""
    D, K, ter, wld, leg, fix = v
    parts = ["physics_step"]
    if (D, K) != (3, 4):
        parts.append(f"{D}x{K}")
    parts += [s for s, on in (("terrain", ter), ("world", wld),
                              ("legacy", leg), ("fixed_base", fix)) if on]
    return "_".join(parts)


def sources_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _compile(cmd, out_path):
    """Run a compiler command that writes ``out_path`` via a temp file, so a
    concurrent or cut build never leaves a half-written library."""
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out_path))
    os.close(fd)
    try:
        proc = subprocess.run(list(cmd) + ["-o", tmp], capture_output=True,
                              text=True, cwd=CSRC_DIR)
        if proc.returncode != 0:
            raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


def cuda_library_path(variant: Variant, phase_clocks: bool = False) -> str:
    D, K, ter, wld, leg, fix = variant
    return os.path.join(ROOT_DIR, "build", "torch_kernels", sources_hash()
                        + ("-clocks" if phase_clocks else ""),
                        f"libphysics_step_{D}x{K}_t{ter}w{wld}l{leg}f{fix}.so")


def build_cuda_library(variant: Variant, phase_clocks: bool = False):
    """Build (or find) one variant's CUDA library; returns (path, compiler
    log, seconds of its nvcc). The log holds ptxas's register, spill and
    shared-memory lines; it is empty, and the seconds 0, when the library
    was already built from these sources. With ``phase_clocks`` the timing
    build (``-DRL_PHASE_CLOCKS``, into a directory of its own): the first
    warp of block 0 notes ``clock64()`` at its start and after every team
    phase."""
    if tuple(variant) not in CUDA_VARIANTS:
        raise ValueError(f"{variant} is not a variant of CUDA_VARIANTS")
    out = cuda_library_path(variant, phase_clocks)
    if os.path.exists(out):
        return out, "", 0.0
    nvcc = _nvcc()
    defs = [f"-DRL_{k}={v}" for k, v in zip(
        ("D", "K", "TER", "WLD", "LEG", "FIX"), variant)]
    t = time.perf_counter()
    log = _compile([nvcc, *NVCC_FLAGS, *defs,
                    *(["-DRL_PHASE_CLOCKS"] if phase_clocks else []),
                    "physics_step.cu"], out)
    return out, log, time.perf_counter() - t


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build the physics kernels")
    return nvcc


def geom_terrain_library_path() -> str:
    return os.path.join(ROOT_DIR, "build", "torch_kernels", sources_hash(),
                        "libgeom_terrain.so")


def build_geom_terrain_library():
    """Build (or find) the terrain lookup's CUDA library; returns (path,
    compiler log, seconds of its nvcc), as :func:`build_cuda_library`."""
    out = geom_terrain_library_path()
    if os.path.exists(out):
        return out, "", 0.0
    t = time.perf_counter()
    log = _compile([_nvcc(), *NVCC_FLAGS, "geom_terrain.cu"], out)
    return out, log, time.perf_counter() - t


def _in_parallel(jobs: List[Callable[[], tuple]]) -> List[tuple]:
    """Run build jobs at once, as many as the machine has cores."""
    if not jobs:
        return []
    with ThreadPoolExecutor(max(1, min(len(jobs),
                                       os.cpu_count() or 1))) as pool:
        return list(pool.map(lambda job: job(), jobs))


def build_host_library(build_dir: str, lanes_reversed: bool = False) -> str:
    """Build the CPU library of the kernel body with g++ into build_dir;
    with ``lanes_reversed`` each phase runs its lanes last to first (the
    bits change only where a phase has a race between lanes)."""
    rev = "_reversed" if lanes_reversed else ""
    out = os.path.join(build_dir,
                       f"libphysics_step_host{rev}_{sources_hash()}.so")
    if not os.path.exists(out):
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found")
        _compile([gxx, *HOST_FLAGS,
                  *(["-DRL_HOST_LANES_REVERSED"] if lanes_reversed else []),
                  "physics_step_host.cpp"], out)
    return out


def build_geom_terrain_host_library(build_dir: str) -> str:
    """Build the CPU library of the terrain lookup's body with g++ into
    build_dir: the whole body and each of its halves
    (:func:`load_geom_terrain_host_library`)."""
    out = os.path.join(build_dir, f"libgeom_terrain_host_{sources_hash()}.so")
    if not os.path.exists(out):
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found")
        _compile([gxx, *HOST_FLAGS, "geom_terrain_host.cpp"], out)
    return out


# rl_geom_terrain's arguments (rl_geom_terrain_host's all of them): x, cst,
# n, D, K, ng, ct, the grid, H, W, border, scale, ix0, iy0, rows, cols, xy
_GT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]


def load_geom_terrain_host_library(path: str):
    lib = ctypes.CDLL(path)
    lib.rl_geom_terrain_host.argtypes = _GT_ARGS
    lib.rl_geom_xy_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    *[ctypes.c_int] * 4, ctypes.c_void_p]
    lib.rl_geom_lookup_host.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 4]
    for fn in (lib.rl_geom_terrain_host, lib.rl_geom_xy_host,
               lib.rl_geom_lookup_host):
        fn.restype = ctypes.c_int
    return lib


def load_host_library(path: str):
    lib = ctypes.CDLL(path)
    fn = lib.rl_physics_step_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return lib


def pack_constants(model, sim_cfg, layout: LimbLayout,
                   world_boxes: Optional[WorldBoxes] = None,
                   world_friction: float = 1.0) -> np.ndarray:
    """Flat float32 table of the robot model, the solver constants and the
    world boxes (none: a world block of 0 boxes). Products of constants are
    formed in float64 and rounded once, as the plain version forms them in
    python floats."""
    D, K = layout.D, layout.K
    if (D, K) not in LAYOUTS:
        raise NotImplementedError(f"limb layout {D}x{K} is not compiled")
    if model.ng > MAX_NG or model.nr > MAX_NR:
        raise NotImplementedError(
            f"ng={model.ng} / nr={model.nr} exceed {MAX_NG} / {MAX_NR}")
    nsub = max(int(sim_cfg.num_substeps), 1)
    dt = sim_cfg.dt / nsub
    parent = np.asarray(model.parent)
    nbox = 0 if world_boxes is None else int(world_boxes.centers.shape[0])
    t = np.zeros(HDR + BASE_SIZE + D * K * SLOT + model.ng * GEOM + W_HDR
                 + nbox * W_BOX)
    t[0:18] = [nsub, dt, 1.0 / dt, 0.5 * dt, float(sim_cfg.gravity[2]),
               sim_cfg.erp / dt, sim_cfg.max_depenetration_velocity,
               sim_cfg.bounce_threshold_velocity, sim_cfg.joint_friction,
               float(getattr(sim_cfg, "torsional_patch_radius", 0.0)),
               float(max(int(np.sum(parent == 0)), 1)),
               float(model.mass[0]), model.ng, model.nr,
               sim_cfg.contact_stiffness, sim_cfg.contact_damping,
               sim_cfg.contact_stiffness * dt, sim_cfg.friction_vel_eps]
    t[HDR:HDR + 3] = model.com[0]
    t[HDR + 3:HDR + 12] = np.asarray(model.inertia[0]).reshape(-1)
    slot_of_body = np.zeros(model.nb, np.int64)
    for d in range(D):
        for k in range(K):
            s = d * K + k
            b = int(layout.body_index[d, k])
            j = b - 1
            slot_of_body[b] = 1 + s
            ax = np.asarray(model.axis[j], np.float64)
            sk = np.array([[0.0, -ax[2], ax[1]], [ax[2], 0.0, -ax[0]],
                           [-ax[1], ax[0], 0.0]])
            o = HDR + BASE_SIZE + s * SLOT
            t[o:o + 9] = np.asarray(model.E_tree[j]).reshape(-1)
            t[o + 9:o + 12] = model.p_tree[j]
            t[o + 12:o + 15] = ax
            t[o + 15:o + 24] = (sk @ sk).reshape(-1)
            t[o + 24:o + 60] = np_spatial_inertia(
                float(model.mass[b]), np.asarray(model.com[b]),
                np.asarray(model.inertia[b])).reshape(-1)
            t[o + 60:o + 66] = [model.dof_armature[j], model.dof_damping[j],
                                model.dof_lower[j], model.dof_upper[j],
                                model.dof_velocity[j], j]
            # the kernel takes the parent of level d > 0 to be level d - 1
            # of the same limb, as detect_limbs builds the layout
            if d > 0:
                assert parent[b] == int(layout.body_index[d - 1, k])
    go = HDR + BASE_SIZE + D * K * SLOT
    c_n = sim_cfg.contact_damping + sim_cfg.contact_stiffness * dt
    for g in range(model.ng):
        o = go + g * GEOM
        m_eff = float(model.mass[int(model.geom_body[g])])
        t[o:o + 8] = [slot_of_body[int(model.geom_body[g])],
                      model.geom_report_body[g], *model.geom_offset[g],
                      model.geom_radius[g], m_eff, 1.0 + c_n * dt / m_eff]
    wo = go + model.ng * GEOM
    t[wo:wo + 5] = [nbox, sim_cfg.contact_stiffness, c_n, world_friction,
                    sim_cfg.friction_vel_eps]
    if nbox:
        boxes = np.concatenate(
            [world_boxes.centers.detach().cpu().double().numpy(),
             world_boxes.half_extents.detach().cpu().double().numpy()], -1)
        t[wo + W_HDR:] = boxes.reshape(-1)
    return t.astype(np.float32)


def terrain_row(model, has_imp: bool) -> int:
    """The first of the packed input's terrain rows: after the state, the
    torques, the 6 DR rows and, with ``has_imp``, the implicit damping."""
    return 13 + 3 * model.nv + 6 + (model.nv if has_imp else 0)


def pack_inputs(model, state: SimState, tau, params: PhysParams,
                implicit_damp, terrain: Optional[TerrainGrid] = None,
                geom_terrain=None, env_origin=None) -> torch.Tensor:
    """[C_in, N] float32 channel-major input of the kernel. With a terrain
    grid, ``geom_terrain`` is (height [N, ng], normal [N, ng, 3]) under
    each geom (:func:`.soa_physics.sample_geom_terrain`), or None to leave
    the terrain rows unwritten for
    :meth:`PhysicsStepKernel.launch_geom_terrain`; with world boxes,
    ``env_origin`` [N, 3] places them."""
    chans = [state.base_pos.T, state.base_quat.T, state.base_lin_vel.T,
             state.base_ang_vel.T, state.q.T, state.qd.T, tau.T,
             params.payload[None], params.com_displacement.T,
             params.restitution[None],
             (0.5 * (params.friction + static_friction(terrain)))[None]]
    if implicit_damp is not None:
        chans.append(implicit_damp.T)
    N, ng = state.q.shape[0], model.ng
    ct = terrain_row(model, implicit_damp is not None)
    c_in = (ct + (4 * ng if terrain is not None else 0)
            + (3 if env_origin is not None else 0))
    x = torch.empty((c_in, N), dtype=torch.float32, device=state.q.device)
    torch.cat(chans, dim=0, out=x[:ct])
    if terrain is not None and geom_terrain is not None:
        hh, nn = geom_terrain
        x[ct:ct + ng] = hh.T
        x[ct + ng:ct + 4 * ng] = nn.reshape(N, -1).T
    if env_origin is not None:
        x[c_in - 3:] = env_origin.T
    return x


def geom_terrain_at(model, sim_cfg, layout, state: SimState,
                    terrain: TerrainGrid, window: Optional[Window]):
    """The terrain rows' values at ``state`` (the call's entry state), by
    the plain version of the lookup kernel."""
    return sample_geom_terrain(
        model, layout, sim_cfg, terrain, _v3(state.base_pos),
        tuple(state.base_quat[:, i] for i in range(4)),
        [state.q[:, j] for j in range(model.nv)], window)


def out_channels(model) -> int:
    return 13 + 2 * model.nv + 3 * model.nr + 3 * model.ng


def unpack_outputs(model, y: torch.Tensor) -> StepOutput:
    nv, nr, ng = model.nv, model.nr, model.ng
    N = y.shape[1]
    parts = torch.split(y, [3, 4, 3, 3, nv, nv, 3 * nr, 3 * ng], dim=0)
    state = SimState(*(p.T for p in parts[:6]))
    report = parts[6].T.reshape(N, nr, 3)
    geom_pos = parts[7].T.reshape(N, ng, 3)
    return StepOutput(state, report, geom_pos)


def _check_inputs(model, state, tau, params, implicit_damp, device,
                  terrain=None, env_origin=None):
    N = state.q.shape[0]
    want = {
        "base_pos": (state.base_pos, (N, 3)),
        "base_quat": (state.base_quat, (N, 4)),
        "base_lin_vel": (state.base_lin_vel, (N, 3)),
        "base_ang_vel": (state.base_ang_vel, (N, 3)),
        "q": (state.q, (N, model.nv)),
        "qd": (state.qd, (N, model.nv)),
        "tau": (tau, (N, model.nv)),
        "friction": (params.friction, (N,)),
        "restitution": (params.restitution, (N,)),
        "payload": (params.payload, (N,)),
        "com_displacement": (params.com_displacement, (N, 3)),
    }
    if implicit_damp is not None:
        want["implicit_damp"] = (implicit_damp, (N, model.nv))
    if env_origin is not None:
        want["env_origin"] = (env_origin, (N, 3))
    for name, (t, shape) in want.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if terrain is not None:
        h = terrain.height
        if h.device != device or h.dtype != torch.float32 or h.dim() != 2:
            raise ValueError(f"terrain height must be a 2-D float32 tensor "
                             f"on {device}")
    if N == 0:
        raise ValueError("no envs")


def _check_world(world_boxes, env_origin):
    if (world_boxes is None) != (env_origin is None):
        raise ValueError("world boxes and env origins go together")


def legacy_contact(sim_cfg) -> bool:
    return getattr(sim_cfg, "contact_model", "apparent") == "legacy"


class PhysicsStepKernel:
    """The built CUDA libraries (one per variant, and the terrain
    lookup's), the constant tables, and the launch counts.

    ``launches`` grows by one at each physics kernel launch and nowhere
    else, and ``variant_launches[variant]`` with it; ``terrain_launches``
    counts the launches on terrain among them, ``world_launches`` those
    with world boxes, ``legacy_launches`` those with the legacy contact
    model and ``fixed_base_launches`` those with a fixed base (a launch
    counts in each that applies: a fixed-base launch is also a legacy
    launch). ``geom_terrain_launches`` grows by one at each launch of the
    terrain lookup kernel and nowhere else."""

    def __init__(self, phase_clocks: bool = False):
        self.phase_clocks = phase_clocks   # the timing build
        self.launches = 0
        self.terrain_launches = 0
        self.world_launches = 0
        self.legacy_launches = 0
        self.fixed_base_launches = 0
        self.variant_launches: Dict[Variant, int] = {}
        self.geom_terrain_launches = 0
        # {variant: (path, compiler log, seconds of its nvcc)}
        self.builds: Dict[Variant, tuple] = {}
        # the same for the terrain lookup's library, once built
        self.geom_terrain_build: Optional[tuple] = None
        self._libs = {}
        self._gt_lib = None
        self._tables = {}

    def zero_counts(self):
        self.launches = self.terrain_launches = self.world_launches = 0
        self.legacy_launches = self.fixed_base_launches = 0
        self.geom_terrain_launches = 0
        self.variant_launches = {}

    def _bind(self, variant: Variant, path: str):
        lib = ctypes.CDLL(path)
        lib.rl_physics_step.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            *[ctypes.c_int] * 8, ctypes.c_void_p]
        lib.rl_physics_step.restype = ctypes.c_int
        lib.rl_physics_step_occupancy.argtypes = [*[ctypes.c_int] * 7,
                                                  ctypes.c_void_p]
        lib.rl_physics_step_occupancy.restype = ctypes.c_int
        if self.phase_clocks:
            lib.rl_phase_clocks.argtypes = [ctypes.c_void_p]
            lib.rl_phase_clocks.restype = ctypes.c_int
        self._libs[variant] = lib
        return lib

    def _bind_geom_terrain(self, built: tuple):
        lib = ctypes.CDLL(built[0])
        lib.rl_geom_terrain.argtypes = _GT_ARGS + [ctypes.c_void_p]
        lib.rl_geom_terrain.restype = ctypes.c_int
        self.geom_terrain_build = built
        self._gt_lib = lib
        return lib

    def build_all(self, variants: Sequence[Variant] = CUDA_VARIANTS
                  ) -> Dict[Variant, tuple]:
        """Build every variant's library and the terrain lookup's in
        parallel, an nvcc each, and bind them; returns the variants'
        builds (the lookup's is :attr:`geom_terrain_build`)."""
        todo = [tuple(v) for v in variants if tuple(v) not in self._libs]
        jobs = [lambda v=v: build_cuda_library(v, self.phase_clocks)
                for v in todo]
        if self._gt_lib is None:
            jobs.append(build_geom_terrain_library)
        built = _in_parallel(jobs)
        for v, b in zip(todo, built):
            self.builds[v] = b
            self._bind(v, b[0])
        if self._gt_lib is None:
            self._bind_geom_terrain(built[-1])
        return {tuple(v): self.builds[tuple(v)] for v in variants}

    def load_geom_terrain(self):
        """Build the terrain lookup's library if needed and bind it."""
        if self._gt_lib is None:
            self._bind_geom_terrain(build_geom_terrain_library())
        return self._gt_lib

    def load(self, variant: Variant):
        """Build the variant's library if needed and bind its entry
        points."""
        variant = tuple(variant)
        lib = self._libs.get(variant)
        if lib is None:
            self.builds[variant] = build_cuda_library(variant,
                                                      self.phase_clocks)
            lib = self._bind(variant, self.builds[variant][0])
        return lib

    def occupancy(self, cst_len: int, has_terrain: bool = False,
                  has_world: bool = False, legacy: bool = False,
                  fixed_base: bool = False, layout=(3, 4)) -> dict:
        """What the CUDA runtime reports for a variant's instance with a
        table of ``cst_len`` floats: shared bytes per env and per block,
        envs per block, resident blocks and warps per SM, registers and
        local (stack) bytes per thread."""
        D, K = layout
        v = (D, K, int(has_terrain), int(has_world), int(legacy),
             int(fixed_base))
        out = (ctypes.c_int * 6)()
        err = self.load(v).rl_physics_step_occupancy(cst_len, *v, out)
        if err != 0:
            raise RuntimeError(f"occupancy query failed: cudaError {err}")
        keys = ("scratch_bytes_per_env", "smem_bytes_per_block",
                "envs_per_block", "blocks_per_sm", "registers",
                "local_bytes")
        occ = dict(zip(keys, out))
        occ["warps_per_sm"] = occ["blocks_per_sm"] * occ["envs_per_block"]
        return occ

    def read_phase_clocks(self, variant: Variant) -> list:
        """The timing build's clocks that ``variant`` noted since the last
        read (block 0's first warp: its start, then the end of each team
        phase; at most 512), after which its count starts again."""
        if not self.phase_clocks:
            raise RuntimeError("phase clocks need PhysicsStepKernel("
                               "phase_clocks=True)")
        buf = (ctypes.c_longlong * 512)()
        n = self.load(variant).rl_phase_clocks(buf)
        if n < 0:
            raise RuntimeError("reading the phase clocks failed")
        return list(buf[:n])

    def table(self, model, sim_cfg, layout, device,
              world_boxes: Optional[WorldBoxes] = None,
              world_friction: float = 1.0) -> torch.Tensor:
        boxes = (None if world_boxes is None else tuple(
            torch.cat([world_boxes.centers, world_boxes.half_extents], -1)
            .reshape(-1).tolist()))
        key = (id(model), device, sim_cfg.dt, sim_cfg.num_substeps,
               tuple(sim_cfg.gravity), sim_cfg.erp,
               sim_cfg.max_depenetration_velocity,
               sim_cfg.bounce_threshold_velocity, sim_cfg.joint_friction,
               getattr(sim_cfg, "torsional_patch_radius", 0.0),
               sim_cfg.contact_stiffness, sim_cfg.contact_damping,
               sim_cfg.friction_vel_eps, boxes, world_friction)
        hit = self._tables.get(key)
        # the entry keeps the model alive, so its id cannot be reused
        if hit is None or hit[0] is not model:
            t = torch.from_numpy(pack_constants(model, sim_cfg, layout,
                                                world_boxes, world_friction))
            hit = (model, t.to(device))
            self._tables[key] = hit
        return hit[1]

    def launch_packed(self, x: torch.Tensor, y: torch.Tensor,
                      cst: torch.Tensor, layout: LimbLayout, has_imp: bool,
                      has_terrain: bool = False, has_world: bool = False,
                      legacy: bool = False, fixed_base: bool = False):
        """Launch on packed [C_in, N] input and [C_out, N] output arrays on
        the current stream; raises if the launch fails. An input packed
        without the implicit-damping rows (``has_imp`` false) gets rows of
        zeros in their place."""
        if fixed_base and not legacy:
            raise ValueError(FIXED_BASE_APPARENT)
        variant = variant_of(layout, has_terrain, has_world, legacy,
                             fixed_base)
        if variant not in CUDA_VARIANTS:
            raise ValueError(f"limb layout {layout.D}x{layout.K} has no "
                             f"kernel (layouts {LAYOUTS})")
        for t in (x, y, cst):
            if (t.device.type != "cuda" or t.dtype != torch.float32
                    or not t.is_contiguous()):
                raise ValueError("kernel arrays must be contiguous float32 "
                                 "CUDA tensors")
        if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
            raise ValueError(f"input {tuple(x.shape)} and output "
                             f"{tuple(y.shape)} disagree on the env count")
        if not has_imp:
            # the damping rows follow the state, tau and the 6 DR rows
            c = 13 + 3 * layout.D * layout.K + 6
            x = torch.cat([x[:c], x.new_zeros((layout.D * layout.K,
                                               x.shape[1])), x[c:]])
        lib = self.load(variant)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rl_physics_step(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            ctypes.c_void_p(cst.data_ptr()), cst.numel(), x.shape[1],
            *variant, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"physics kernel launch failed: cudaError {err}")
        self.launches += 1
        self.variant_launches[variant] = (
            self.variant_launches.get(variant, 0) + 1)
        self.terrain_launches += int(has_terrain)
        self.world_launches += int(has_world)
        self.legacy_launches += int(legacy)
        self.fixed_base_launches += int(fixed_base)

    def launch_geom_terrain(self, x: torch.Tensor, cst: torch.Tensor,
                            layout: LimbLayout, ng: int, ct: int,
                            terrain: TerrainGrid,
                            window: Optional[Window] = None,
                            xy: Optional[torch.Tensor] = None):
        """Launch the terrain lookup on the packed [C_in, N] input ``x`` on
        the current stream: it reads the state rows and writes the ng
        height rows and 3 ng normal rows from row ``ct``, looked up through
        ``window`` (None: the whole grid); with ``xy`` [2 ng, N] also each
        geom's world (x, y). Raises if the launch fails."""
        h = terrain.height
        arrays = [x, cst, h] + ([] if xy is None else [xy])
        for t in arrays:
            if (t.device.type != "cuda" or t.dtype != torch.float32
                    or not t.is_contiguous() or t.device != x.device):
                raise ValueError("lookup arrays must be contiguous float32 "
                                 "tensors on one CUDA device")
        N = x.shape[1]
        if x.dim() != 2 or h.dim() != 2 or ct + 4 * ng > x.shape[0]:
            raise ValueError(f"input {tuple(x.shape)} has no {4 * ng} "
                             f"terrain rows from row {ct}")
        if xy is not None and tuple(xy.shape) != (2 * ng, N):
            raise ValueError(f"xy has shape {tuple(xy.shape)}, expected "
                             f"{(2 * ng, N)}")
        H, W = h.shape
        if window is None:
            ix0 = iy0 = None
            rows, cols = H, W
        else:
            ix0, iy0, rows, cols = window
            for t in (ix0, iy0):
                if (t.device != x.device or t.dtype != torch.int64
                        or not t.is_contiguous() or tuple(t.shape) != (N,)):
                    raise ValueError("window corners must be contiguous "
                                     "int64 [N] tensors on the input's "
                                     "device")
        lib = self.load_geom_terrain()

        def ptr(t):
            return ctypes.c_void_p(None if t is None else t.data_ptr())
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rl_geom_terrain(
            ptr(x), ptr(cst), N, layout.D, layout.K, ng, ct, ptr(h), H, W,
            terrain.border_size, terrain.horizontal_scale, ptr(ix0),
            ptr(iy0), rows, cols, ptr(xy), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"terrain lookup launch failed: cudaError "
                               f"{err}")
        self.geom_terrain_launches += 1

    def __call__(self, model, sim_cfg, state, tau, params, implicit_damp,
                 layout, terrain=None, terrain_window=None, world_boxes=None,
                 env_origin=None, world_friction=1.0,
                 fixed_base: bool = False) -> StepOutput:
        device = state.q.device
        _check_world(world_boxes, env_origin)
        _check_inputs(model, state, tau, params, implicit_damp, device,
                      terrain, env_origin)
        if implicit_damp is None:
            implicit_damp = torch.zeros_like(tau)
        cst = self.table(model, sim_cfg, layout, device, world_boxes,
                         world_friction)
        # the terrain rows are left to the lookup kernel
        x = pack_inputs(model, state, tau, params, implicit_damp, terrain,
                        None, env_origin)
        if terrain is not None:
            win = lookup_window(sim_cfg, terrain, state.base_pos[:, 0],
                                state.base_pos[:, 1], terrain_window)
            self.launch_geom_terrain(x, cst, layout, model.ng,
                                     terrain_row(model, True), terrain, win)
        y = torch.empty((out_channels(model), x.shape[1]),
                        dtype=torch.float32, device=device)
        self.launch_packed(x, y, cst, layout, True, terrain is not None,
                           world_boxes is not None, legacy_contact(sim_cfg),
                           fixed_base)
        return unpack_outputs(model, y)


KERNEL = PhysicsStepKernel()


def physics_step_cuda(
    model,
    sim_cfg,
    state: SimState,               # batched [N,...]
    tau: torch.Tensor,             # [N,nv]
    params: PhysParams,            # batched
    terrain: Optional[TerrainGrid] = None,
    fixed_base: bool = False,
    implicit_damp: Optional[torch.Tensor] = None,   # [N,nv] Kd_eff+dt*Kp_eff
    world_boxes=None,
    env_origin: Optional[torch.Tensor] = None,
    world_friction: float = 1.0,
    terrain_window: Optional[Window] = None,
) -> StepOutput:
    """One control-step physics call: the CUDA kernel for tensors on the
    card, the plain version for tensors on the CPU. ``terrain_window`` is
    the env's hoisted per-step window into the grid
    (:func:`.soa_physics.sample_geom_terrain`); ``world_boxes`` sit at each
    env's ``env_origin``."""
    layout = check_supported(model, sim_cfg, terrain, world_boxes,
                             fixed_base)
    _check_world(world_boxes, env_origin)
    device = state.q.device
    if device.type == "cpu":
        return physics_step_soa(model, sim_cfg, state, tau, params,
                                terrain=terrain, fixed_base=fixed_base,
                                implicit_damp=implicit_damp,
                                world_boxes=world_boxes,
                                env_origin=env_origin,
                                world_friction=world_friction,
                                terrain_window=terrain_window)
    if device.type != "cuda":
        raise ValueError(f"no physics step for device {device}")
    return KERNEL(model, sim_cfg, state, tau, params, implicit_damp, layout,
                  terrain, terrain_window, world_boxes, env_origin,
                  world_friction, fixed_base)


def physics_step_host(lib, model, sim_cfg, state: SimState, tau,
                      params: PhysParams,
                      implicit_damp: Optional[torch.Tensor] = None,
                      terrain: Optional[TerrainGrid] = None,
                      terrain_window: Optional[Window] = None,
                      world_boxes: Optional[WorldBoxes] = None,
                      env_origin: Optional[torch.Tensor] = None,
                      world_friction: float = 1.0,
                      fixed_base: bool = False) -> StepOutput:
    """The kernel's per-env body built for the CPU (``lib`` from
    :func:`load_host_library`), on CPU tensors, through the same packing."""
    layout = check_supported(model, sim_cfg, terrain=terrain,
                             world_boxes=world_boxes, fixed_base=fixed_base)
    _check_world(world_boxes, env_origin)
    _check_inputs(model, state, tau, params, implicit_damp,
                  torch.device("cpu"), terrain, env_origin)
    cst = torch.from_numpy(pack_constants(model, sim_cfg, layout,
                                          world_boxes, world_friction))
    gt = (None if terrain is None else geom_terrain_at(
        model, sim_cfg, layout, state, terrain, terrain_window))
    x = pack_inputs(model, state, tau, params, implicit_damp, terrain, gt,
                    env_origin)
    N = x.shape[1]
    y = torch.empty((out_channels(model), N), dtype=torch.float32)
    err = lib.rl_physics_step_host(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
        ctypes.c_void_p(cst.data_ptr()), N, layout.D, layout.K,
        int(implicit_damp is not None), int(terrain is not None),
        int(world_boxes is not None), int(legacy_contact(sim_cfg)),
        int(fixed_base))
    if err != 0:
        raise RuntimeError(f"host physics step refused layout "
                           f"{layout.D}x{layout.K}")
    return unpack_outputs(model, y)
