#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Imports torch and the port (``rapid_locomotion_rl_tpu_torch``) only. Each
phase prints one flushed line with the seconds elapsed; a failed phase
raises and the script exits non-zero. (``--sharded-rank`` and its options
run one rank of the ``sharded`` phase; the smoke run takes no argument.)

1. device:   a CUDA card, its name and power limit (nvidia-smi).
2. build:    nvcc builds the physics kernel from csrc/, one library per
             variant, all 24 at once (as many nvcc as the machine has
             cores): both limb layouts of the repo (the quadruped's 3 x 4,
             the test hopper's 1 x 2) on the plane or terrain, with or
             without world boxes, with the apparent or the legacy contact
             model, and with the legacy model also a fixed base; each
             build's seconds, ptxas's register, spill and stack lines; per
             variant, the CUDA runtime's shared bytes per env and per
             block, resident warps per SM, registers and local bytes per
             thread.
3. kernel:   the plane variant against its plain PyTorch version on Go1 at
             4096 envs, on states made from a numpy seed: torque-free
             flight at rtol/atol 2e-5 on state and 1e-5 on geom positions;
             grounded states with random torques: >= 99% of entries of
             every state field and of the non-zero contact forces within
             atol + 1e-3 |ref|, geom positions at 1e-5; two launches on
             one input bitwise equal; kernel times by CUDA events at the
             main path's width and at 1024 envs, and the plain time.
4. terrain:  the terrain variant, the same way, on Mini Cheetah at 4000
             envs spread over the default TerrainCfg mix (slopes, stairs,
             obstacles; the flagship's own grid is flat), looked up through
             the env's column-block window.
5. world:    the terrain + world variant, the same way, at the HLP's own
             width (1024 Mini Cheetah envs), in the HLP's corridor around
             each env's origin over the same mix, spheres clear of,
             touching, crossing and inside the walls; flight inside the
             walls' height at rtol/atol 2e-5 and the report entries that
             the walls change at 2e-4/2e-3; grounded states in bulk. Its
             numbers go into the kernels line. Then the same checks and
             times at 4000 envs (the flagship's width), for comparison.
6. legacy:   the legacy-contact variant (SimCfg.contact_model "legacy")
             held and timed the same way as the terrain variant at 4000
             Mini Cheetah envs over the same mix; then config_mini_cheetah
             with that contact model under the runs/r5_flagship policy for
             one 24-step horizon: all 96 physics calls through the variant,
             the state finite.
7. fixed-base: the same for the fixed base (AssetCfg.fix_base_link) with
             the legacy contact model (the port refuses a fixed base with
             the apparent model, which gives NaN in the JAX package's SoA
             step); the kernel returns each input base pose unchanged
             and zero base velocities, and over the horizon every base
             stays where its last reset put it.
7b. variants: the variants beyond the five of phases 3-7, each held and
             timed by the rules of the variant it extends (3-5, the fixed
             base exactly): on the plane Go1 at 4096 envs with the legacy
             contact model, with it and a fixed base, in the corridor's
             walls, and in the walls with the legacy model (and a fixed
             base); on the mix Mini Cheetah at 4000 in the walls with the
             legacy model (and a fixed base); the hopper's twelve at 4096
             (its URDF written to a temp dir). Their flight in the walls
             is held by the CPU tests' rule for states in a wall
             (hold_in_walls).
8. rollout:  the Go1 env (config_go1, 4096 envs, plane) with the
             runs/r4_go1 policy weights; one PPO horizon (24 steps) of
             teacher-policy rollout; outputs finite; the plane variant
             launched exactly 24 x decimation times; env-steps/s and peak
             memory.
8b. go1-legacy: config_go1 with sim.contact_model "legacy" under the
             runs/r4_go1 policy, two iterations of train_iteration: every
             physics call through the plane + legacy variant, finite.
9. train:    scripts/train_cuda.py's main on the flagship
             (config_mini_cheetah, 4000 envs, trimesh), resumed from
             runs/r5_flagship's full train state (params, both Adam states,
             LR, env state with its command curriculum), 2 Runner
             iterations (24-step rollout, GAE, 5 x 4 minibatches of PPO
             with the adaptive-KL LR and the adaptation-module step) into a
             scratch logdir; 96 terrain-variant launches per iteration and
             no other; finite losses and params; KL in [0.003, 0.1] and LR
             in [1e-5, 1e-2], off its 1e-5 floor; mean base z in
             (0.15, 0.5) m, done rate under 5%; r5_flagship's metric keys;
             the checkpoint read back equal; the rollout/update split,
             env-steps/s of the iteration and peak memory. Iteration 4000
             is on the video cadence: the pose buffer holds env 0's
             [24, ...] pose arrays, videos/04000.gif is written, and
             student_policy_latest.pt2 reloads to the policy's
             act_student on the run's observations (torch.equal).
9b. corridor-legacy: config_mini_cheetah with the corridor's walls and
             the legacy contact model under the runs/r5_flagship policy,
             two iterations: every call through terrain + walls + legacy.
9c. env-variants: the variants no script reaches, each through the env
             of a user's config (Go1 in the walls, with the legacy model
             and a fixed base, both in the walls; Mini Cheetah in the walls
             with the legacy model and a fixed base) for 2 steps, and the
             hopper's twelve through physics_step_cuda, 4 calls each.
9d. sharded: data parallelism (parallel/sharding.py): (a)
             scripts/train_cuda.py --distributed --mesh data --iterations 2
             as a world-size-1 NCCL process, one checkpoint; (b) one
             flagship iteration resumed from runs/r5_flagship at 4000 envs
             over two gloo processes on the card (2 x 2000) against one
             process: KL and value loss at rtol 1e-3 / atol 1e-5, the
             actor's first bias at rtol 1e-4 / atol 1e-6 and every leaf on
             >= 99.9% of its entries, the LR and curriculum weights equal;
             the wall times of both.
10. hlp:     scripts/high_level_play_cuda.py's main path: the frozen
             runs/r4_flagship_4000 student under the goal-navigation env at
             1024 envs (trimesh), r5_hlp7's recipe, resumed from its train
             state, 2 Runner iterations of 200 steps (800 terrain-variant
             launches each); finite losses, KL, LR and params, LR in
             [1e-5, 1e-3], r5_hlp7's metric keys, the checkpoint read back
             equal, at least one goal reached; the rollout/update split,
             env-steps/s and peak memory.
11. hlp-world: the same entry with the corridor on, from a fresh state: one
             iteration, all 800 physics calls through the terrain + world
             variant, finite results, some env against a wall; then the
             kernel against its plain version on the low-level state at
             the iteration's end (in bulk, and the report entries that the
             walls change).
12. play:    scripts/play_cuda.py's play() on runs/r4_flagship_4000: 1 env,
             150 steps at vx 1.0, a GIF; 600 terrain-variant launches and
             no other; the state finite, the base 0.15-0.5 m above its
             origin at every step, no reset; the mean vx of the last 100
             steps printed.
13. test:    scripts/test_cuda.py's run_env(3, 100): 400 terrain-variant
             launches, finite rewards, the heights printed.
14. eval:    scripts/eval_sweep_cuda.py's evaluate() on
             runs/r4_flagship_4000, preset static_medium, 256 envs, 50
             steps: 200 terrain-variant launches, every METRICS_FNS key
             present and finite, done_rate under 0.05.
15. hlp-play: scripts/hlp_play_cuda.py on runs/r5_hlp7 (16 envs, 50 steps,
             a GIF): 200 terrain-variant launches, the state finite, the
             goals, timeouts and falls printed.
             Phases 12-15 each then hold the terrain variant to its plain
             version on the state the phase ends on (1, 3, 256 and 16
             envs: the last block of 8 only partly filled at 1 and 3), by
             the rules of phase 4 on the env's own window, and time it.
             Each GIF (and videos/04000.gif) must hold at least 2 frames;
             without Pillow the phase holds render_frame_rgb's array
             instead (its shape, the robot's and the terrain's pixels).
16. aos:     the general (AoS) step, ops/physics.py, plain PyTorch and not
             a kernel: on the card against the same code on the CPU at 256
             Mini Cheetah envs over the mix, torque-free flight at
             rtol/atol 2e-5 and grounded states with random torques by
             phase 3's bulk rule, for both contact models; at 4000 envs
             against K1's terrain (and legacy) variant in bulk, at the
             repo's AoS-vs-SoA floor of 90%, on the state (the AoS step
             reports the last substep's contact forces, K1 the first's);
             ms, aten operations and CUDA kernels (torch.profiler) per
             call.
17. aos-train: scripts/train_cuda.py's main with --physics-impl aos on the
             flagship, resumed from runs/r5_flagship, one iteration: no K1
             launch, finite losses and params, KL in [0.003, 0.1], LR in
             [1e-5, 1e-2], mean base z in (0.15, 0.5) m; env-steps/s and
             the rollout/update split.
18. mjcf:    config_go1 with resources/robots/go1/xml/go1.xml (ng 38, nr
             13, dof_velocity 100), 4096 envs on the plane under the
             runs/r4_go1 policy for one horizon: exactly 96 plane-variant
             launches, finite; the variant held to its plain version on
             the end state by phase 3's rules, and timed; then the same
             env on the AoS step for a horizon, finite, no K1 launch.
19. heights: config_mini_cheetah with terrain.measure_heights (187 points,
             229 observations) at 4000 envs on its trimesh under a fresh
             policy of that width, one horizon: 96 terrain-variant
             launches, finite; the sensor on the card equal to the same
             rule on the CPU at the same points (exact), on the env's
             state and on the mix's grid, and the contact lookup's cells
             and fractions there.
20. vecenv:  envs/vec_env.py's VecEnvAdapter over Go1 (4096 envs, the
             plane): reset, ten steps, reset_idx (44 plane-variant
             launches); the ten steps' obs split and padded at their
             dones (learn/trajectories.py) and back, equal.
             Phases 16-20 each print their seconds, K1 launches and peak
             memory; the launches of 18-20 join the plane and terrain
             entries of the kernels line.
21. capability: the locomotion-capability gate
             (scripts/torch_capability.py, the JAX package's
             tests/test_locomotion_capability.py at its sizes and
             thresholds) on the plane: an open-loop trot of 4 envs moves
             >= 0.6 m in 300 steps with no done and a final height in
             (0.15, 0.45) m; runs/r4_flagship_4000's policy (teacher, 8
             envs, vx 1.0, 300 steps) makes a median >= 3.6 m; runs/
             ab7_ent0_fixedphys2's (8 envs, command (-1.5, 0, 2.5)) keeps
             a top-4 mean speed > 0.5 m/s over steps 100-300. 3,600
             plane-variant launches; the variant held to its plain version
             on the flagship gate's end state.
22. drift-sweep: scripts/exp_drift_sweep_cuda.py's 72 trot points as 72
             envs of one rollout, the first arm (legacy fit, patch 0.01),
             300 steps: 1,200 plane-variant launches, finite, the best
             forward and backward gaits printed.
23. survival: scripts/diag_survival_cuda.py on config_mini_cheetah at its
             4000 envs on the trimesh with full DR: zero and Gaussian (std
             1) actions, 100 steps each (800 terrain-variant launches), the
             cause breakdowns printed; the variant held on the Gaussian
             arm's end state.
24. terrain-arms: scripts/bench_terrain_cuda.py at 4000 envs, one timed
             24-step scan an arm (mm, take, direct, plane; each arm's
             window printed): ms and env-steps/s per arm, the terrain's
             cost over the plane.
25. diag-hlp: scripts/diag_hlp_cuda.py's zero, straight and pcontrol arms
             on the frozen runs/r4_flagship_4000 student, 16 envs, 100
             steps each (1,200 terrain-variant launches), finite.
26. tracking-only: scripts/exp_tracking_only_cuda.py, 2048 envs on the
             plane, 2 Runner iterations (192 plane-variant launches):
             finite losses, KL, LR and parameters.
             Phases 21-26 each print their seconds, K1 launches and peak
             memory; their launches join the plane and terrain entries of
             the kernels line.
27. result:  the kernels line (every variant built for the card, with its
             launches on these paths; the run fails if one has none), the
             card line, and the contract line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

T0 = time.time()
N_ENVS = 4096
N_MC = 4000
N_HLP = 1024
HORIZON = 24
ITERATIONS = 2
SEED = 0
WEIGHTS = os.path.join("runs", "r4_go1", "checkpoints", "ac_weights_last.pkl")
MC_WEIGHTS = os.path.join("runs", "r5_flagship", "checkpoints",
                          "ac_weights_last.pkl")
MC_STATE = os.path.join("runs", "r5_flagship", "checkpoints",
                        "train_state_last.pkl")
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
# FP32 instructions a second outside the tensor cores: 132 SMs x 128 lanes
# x 1.98 GHz. count_ops_per_env counts a multiply and an add as one
# operation each, and the kernel is built with --fmad=false, so each is one
# instruction; the data sheet's 67 TFLOP/s counts a fused multiply-add as two.
H100_FP32_OPS_PER_S = 33.5e12


def say(phase: str, msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {phase}: {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", f"{torch.cuda.get_device_name(0)} | {card_line()} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | count "
        f"{torch.cuda.device_count()}")
    return dev


def phase_build():
    """Every variant's library from csrc/, an nvcc each, all started
    together; each build's seconds and ptxas's registers, spills and
    stack; per variant, what the CUDA runtime reports at its main path's
    table: shared bytes per env and per block, resident warps per SM,
    registers and local (stack) bytes per thread. Returns {variant: build
    seconds}."""
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    from rapid_locomotion_rl_tpu_torch.ops.world import default_corridor
    if set(VARIANT_OF.values()) != set(CP.CUDA_VARIANTS):
        raise AssertionError("VARIANT_OF is not ops/cuda_physics's table")
    t = time.time()
    built = CP.KERNEL.build_all()
    wall = time.time() - t
    secs = {v: built[VARIANT_OF[v]][2] for v in VARIANTS}
    say("build", f"{len(built)} variants in {wall:.2f}s of wall time "
        f"({sum(secs.values()):.1f}s of nvcc in all, up to "
        f"{os.cpu_count()} at once) -> "
        f"{os.path.dirname(built[VARIANT_OF['plane']][0])}")
    go1_cfg, go1 = go1_model()
    mc_cfg, mc = robot(config_mini_cheetah)
    hop_cfg, hop = hopper_model()
    w = mc_cfg.world
    boxes = default_corridor(w.length, w.width, w.wall_height,
                             w.wall_thickness)
    for v in VARIANTS:
        D, K, ter, wld, leg, fix = VARIANT_OF[v]
        log = built[VARIANT_OF[v]][1]
        regs = [x.strip() for x in log.splitlines()
                if any(k in x for k in ("registers", "spill", "stack"))]
        model, cfg = ((hop, hop_cfg) if (D, K) == (1, 2) else
                      (mc, mc_cfg) if ter or wld else (go1, go1_cfg))
        layout = CP.check_supported(model, cfg.sim)
        n_cst = CP.pack_constants(model, cfg.sim, layout,
                                  boxes if wld else None).size
        o = CP.KERNEL.occupancy(n_cst, bool(ter), bool(wld), bool(leg),
                                bool(fix), layout=(D, K))
        say("build", f"{v}: nvcc {secs[v]:.1f}s; table {n_cst * 4} B, "
            f"scratch {o['scratch_bytes_per_env']} B/env, "
            f"{o['smem_bytes_per_block']} B shared/block of "
            f"{o['envs_per_block']} envs, {o['blocks_per_sm']} blocks = "
            f"{o['warps_per_sm']} warps/SM, {o['registers']} registers, "
            f"{o['local_bytes']} B local/thread | ptxas: "
            + " / ".join(regs[-2:]))
    return secs


def robot(config):
    """A config and the robot model it loads."""
    from rapid_locomotion_rl_tpu_torch import ROOT_DIR
    from rapid_locomotion_rl_tpu_torch.models import load_urdf
    cfg = config()
    return cfg, load_urdf(cfg.asset.file.format(ROOT=ROOT_DIR),
                          armature=cfg.asset.armature,
                          mesh_sphere_fit=cfg.asset.mesh_sphere_fit)


def go1_model():
    from rapid_locomotion_rl_tpu_torch.config import config_go1
    return robot(config_go1)


# the 2-limb hopper of the JAX package's tests (tests/test_pallas_physics.py:
# nb 3, nv 2, ng 3, limb layout 1 x 2)
HOPPER_URDF = """<robot name="tiny">
  <link name="base">
    <inertial><mass value="2.0"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.02" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><geometry><sphere radius="0.05"/></geometry></collision>
  </link>
  <joint name="hipL" type="revolute">
    <parent link="base"/><child link="legL"/>
    <origin xyz="0.1 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-2" upper="2" effort="20" velocity="20"/>
  </joint>
  <link name="legL">
    <inertial><mass value="0.3"/>
      <origin xyz="0 0 -0.08"/>
      <inertia ixx="0.001" iyy="0.001" izz="0.0002" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><origin xyz="0 0 -0.15"/>
      <geometry><sphere radius="0.02"/></geometry></collision>
  </link>
  <joint name="hipR" type="revolute">
    <parent link="base"/><child link="legR"/>
    <origin xyz="-0.1 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-2" upper="2" effort="20" velocity="20"/>
  </joint>
  <link name="legR">
    <inertial><mass value="0.3"/>
      <origin xyz="0 0 -0.08"/>
      <inertia ixx="0.001" iyy="0.001" izz="0.0002" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><origin xyz="0 0 -0.15"/>
      <geometry><sphere radius="0.02"/></geometry></collision>
  </link>
</robot>"""


def hopper_model():
    """A Cfg (its SimCfg defaults) and the hopper, loaded from the URDF
    written to a temp dir."""
    import tempfile
    from rapid_locomotion_rl_tpu_torch.config import Cfg
    from rapid_locomotion_rl_tpu_torch.models import load_urdf
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tiny.urdf")
        with open(path, "w") as f:
            f.write(HOPPER_URDF)
        return Cfg(), load_urdf(path)


def hopper_inputs(model, n, seed, airborne, dev):
    """The hopper's draws of tests/test_pallas_physics.py (bases 0.1-0.3 m
    up, legs of 0.17 m: grounded), lifted 1.5 m with zero torques for
    flight."""
    import numpy as np
    import torch
    from rapid_locomotion_rl_tpu_torch.ops.dynamics import PhysParams, SimState
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    arr = dict(
        base_pos=np.concatenate([rng.uniform(-1, 1, (n, 2)),
                                 rng.uniform(0.1, 0.3, (n, 1))
                                 + (1.5 if airborne else 0.0)], -1),
        base_quat=quat, base_lin_vel=rng.uniform(-1, 1, (n, 3)),
        base_ang_vel=rng.uniform(-2, 2, (n, 3)),
        q=rng.uniform(-0.6, 0.6, (n, model.nv)),
        qd=rng.uniform(-3, 3, (n, model.nv)))
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    state = SimState(**{k: f(v) for k, v in arr.items()})
    params = PhysParams(
        friction=f(rng.uniform(0.3, 2.0, n)),
        restitution=f(rng.uniform(0.0, 0.4, n)),
        payload=f(rng.uniform(-0.5, 2.0, n)),
        com_displacement=f(rng.uniform(-0.05, 0.05, (n, 3))))
    tau = f(np.zeros((n, model.nv)) if airborne
            else rng.uniform(-3, 3, (n, model.nv)))
    imp = f(rng.uniform(0.5, 2.0, (n, model.nv)))
    return state, tau, params, imp


def random_inputs(model, n, seed, airborne, dev):
    """States inside the joint limits, DR params, torques and implicit-PD
    impedances made with numpy from a seed."""
    import numpy as np
    import torch
    from rapid_locomotion_rl_tpu_torch.ops.dynamics import PhysParams, SimState
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(model.dof_lower), np.asarray(model.dof_upper)
    quat = rng.normal([0, 0, 0, 4.0], 0.3, (n, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    z0 = 1.5 if airborne else 0.30
    arr = {
        "base_pos": rng.normal([0, 0, z0], [0.5, 0.5, 0.02], (n, 3)),
        "base_quat": quat,
        "base_lin_vel": rng.normal(0, 0.5, (n, 3)),
        "base_ang_vel": rng.normal(0, 0.5, (n, 3)),
        "q": lo + (hi - lo) * rng.uniform(0.1, 0.9, (n, model.nv)),
        "qd": rng.uniform(-4, 4, (n, model.nv)),
    }
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    state = SimState(**{k: f(v) for k, v in arr.items()})
    params = PhysParams(
        friction=f(rng.uniform(0.1, 3.0, n)),
        restitution=f(rng.uniform(0, 1, n)),
        payload=f(rng.uniform(-1, 3, n)),
        com_displacement=f(rng.uniform(-0.1, 0.1, (n, 3))))
    tau = f(np.zeros((n, model.nv)) if airborne
            else rng.uniform(-3, 3, (n, model.nv)))
    imp = f(rng.uniform(0.5, 2.0, (n, model.nv)))
    return state, tau, params, imp


_OPS = {}


def count_ops_per_env(model, sim_cfg, n=8, terrain=False, world=False,
                      fixed_base=False):
    """Arithmetic operations per env of one physics call, counted from the
    plain version's substep chain on the CPU (the kernel's work; with
    ``terrain`` the per-geom heights and normals are inputs, as in the
    kernel; with ``world`` the default corridor's 4 walls act in every
    substep, whatever the spheres' distance to them, as in the kernel;
    ``sim_cfg.contact_model`` and ``fixed_base`` pick the branches):
    every elementwise aten op adds its output's element count (sin, sqrt,
    a comparison or a clamp count as one)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from rapid_locomotion_rl_tpu_torch.envs.world import default_corridor
    from rapid_locomotion_rl_tpu_torch.ops.soa_physics import (
        _v3, check_supported, substep_chain)
    skip = ("view", "select", "slice", "stack", "cat", "unbind", "detach",
            "alias", "_to_copy", "copy", "lift", "scalar_tensor", "expand",
            "unsqueeze", "squeeze", "t.", "transpose", "permute", "clone",
            "empty", "zeros", "full", "split")

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            if isinstance(out, torch.Tensor) and not any(
                    s in name for s in skip):
                Count.ops += out.numel()
            return out

    state, tau, params, imp = random_inputs(model, n, 1, False, "cpu")
    key = (model.name, model.ng, sim_cfg.contact_model, terrain, world,
           fixed_base)
    if key in _OPS:
        return _OPS[key]
    comps = dict(
        base_pos=_v3(state.base_pos),
        base_quat=tuple(state.base_quat[:, i] for i in range(4)),
        base_v=_v3(state.base_lin_vel), base_w=_v3(state.base_ang_vel),
        q=list(state.q.T), qd=list(state.qd.T), tau=list(tau.T),
        imp=list(imp.T), payload=params.payload,
        com_disp=_v3(params.com_displacement),
        restitution=params.restitution, mu=0.5 * (params.friction + 1.0))
    if terrain:
        g = torch.Generator().manual_seed(2)
        n3 = torch.nn.functional.normalize(
            torch.randn(n, model.ng, 3, generator=g) * 0.1
            + torch.tensor([0.0, 0.0, 1.0]), dim=-1)
        comps["g_h"] = list(0.05 * torch.randn(model.ng, n, generator=g))
        comps["g_n"] = [tuple(n3[:, i].T) for i in range(model.ng)]
    boxes = None
    if world:
        boxes = default_corridor()
        comps["origin"] = _v3(state.base_pos * 0.5)
    layout = check_supported(model, sim_cfg)
    with Count():
        substep_chain(model, sim_cfg, layout, comps, boxes,
                      fixed_base=fixed_base)
    _OPS[key] = Count.ops / n
    return _OPS[key]


def time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mostly_close(phase, name, a, b, atol, where=None, label="grounded",
                 frac=0.99):
    """Bulk agreement: states on a contact-branch boundary flip on fp-level
    differences, so grounded states agree entry by entry only in bulk. The
    floor is 99% of entries within atol + 1e-3 |ref|: tighter than the 80%
    of tests/test_soa_physics.py's bulk rule, and borne out on these seeds
    (100% measured on the H100). ``where`` restricts the count to the
    entries it marks; ``frac`` sets another floor."""
    close = (a - b).abs() <= atol + 1e-3 * b.abs()
    if where is not None:
        close = close[where]
    ok = close.float().mean().item()
    say(phase, f"{label} {name}: {ok:.4f} of {close.numel()} within atol "
        f"{atol} (max |err| {(a - b).abs().max().item():.3g})")
    if not ok >= frac:
        raise AssertionError(f"{label} {name}: only {ok:.4f} < {frac} agree")


def check_pinned(phase, state, out):
    """A fixed-base call returns the base pose it was given and zero base
    velocities, exactly."""
    import torch
    if not (torch.equal(out.state.base_pos, state.base_pos)
            and torch.equal(out.state.base_quat, state.base_quat)
            and bool((out.state.base_lin_vel == 0).all())
            and bool((out.state.base_ang_vel == 0).all())):
        raise AssertionError(f"{phase}: the fixed base moved")


def hold_kernel(phase, model, sim, make_inputs, n, terrain=None,
                window=None, boxes=None, origins=None, fixed_base=False,
                sloped=True, plain_reps=2):
    """The kernel against its plain version: torque-free flight strictly,
    grounded states with random torques in bulk; two launches on one input
    bitwise equal; then its time per launch (also at 1024 envs), the plain
    version's time per call, and the bound, at these shapes.
    ``make_inputs(seed, airborne)`` gives (state, tau, params, imp);
    ``window(state)`` the terrain window of the env's step. With world
    ``boxes`` at ``origins`` [N, 3], the flight state flies over the walls
    (the world branch runs and adds nothing), and the grounded state's
    report entries that the walls change are counted and held in bulk.
    ``sim.contact_model`` and ``fixed_base`` pick the variant; with a fixed
    base the kernel's base pose and velocities are checked exactly. With
    ``sloped`` some grounded geom must be near a sloped surface (off for
    an env's own state on a flat grid). ``plain_reps``: the plain
    version's timed calls."""
    import torch
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    from rapid_locomotion_rl_tpu_torch.ops.soa_physics import physics_step_soa
    result = {}

    def both(state, tau, params, imp):
        kw = dict(terrain=terrain, implicit_damp=imp,
                  terrain_window=None if window is None else window(state),
                  world_boxes=boxes, env_origin=origins,
                  fixed_base=fixed_base)
        out_k = CP.physics_step_cuda(model, sim, state, tau, params, **kw)
        torch.cuda.synchronize()
        out_p = physics_step_soa(model, sim, state, tau, params, **kw)
        torch.cuda.synchronize()
        if fixed_base:
            check_pinned(phase, state, out_k)
        return out_k, out_p

    # torque-free flight: no contact, no limit hits -> tight agreement
    out_k, out_p = both(*make_inputs(3, True))
    err = 0.0
    for name in out_p.state._fields:
        a, b = getattr(out_k.state, name), getattr(out_p.state, name)
        if not torch.isfinite(a).all():
            raise AssertionError(f"flight {name}: non-finite kernel output")
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5,
                                   msg=lambda m: f"flight {name}: {m}")
        err = max(err, (a - b).abs().max().item())
    torch.testing.assert_close(out_k.geom_pos, out_p.geom_pos, rtol=1e-5,
                               atol=1e-5)
    if out_k.contact_report.abs().max().item() != 0.0:
        raise AssertionError("flight: contact force reported in the air")
    say(phase, f"flight N={n}: state max |err| {err:.3g} "
        f"(rtol/atol 2e-5), geom_pos ok (1e-5)")
    result["max_abs_err"] = err

    # grounded states with random torques: bulk agreement
    state, tau, params, imp = make_inputs(0, False)
    out_k, out_p = both(state, tau, params, imp)
    if out_p.contact_report.abs().max().item() < 1.0:
        raise AssertionError("grounded case has no contact")
    for name in state._fields:
        atol = 1e-2 if name in ("qd", "base_lin_vel", "base_ang_vel") else 1e-3
        mostly_close(phase, name, getattr(out_k.state, name),
                     getattr(out_p.state, name), atol)
    # most reported forces are zero on both sides: count the others only
    mostly_close(phase, "contact_report", out_k.contact_report,
                 out_p.contact_report, 0.5, where=out_p.contact_report != 0)
    if boxes is not None:
        # the entries that the walls change, against the plain step
        # without them
        free = physics_step_soa(
            model, sim, state, tau, params, terrain=terrain,
            implicit_damp=imp, terrain_window=None if window is None
            else window(state), fixed_base=fixed_base)
        walled = out_p.contact_report != free.contact_report
        say(phase, f"grounded: {int(walled.sum())} report entries changed "
            f"by the walls")
        if int(walled.sum()) == 0:
            raise AssertionError("grounded: no wall force")
        mostly_close(phase, "wall report entries", out_k.contact_report,
                     out_p.contact_report, 0.5, where=walled)
        result["wall_entries_ground"] = int(walled.sum())
    # geom positions are taken before the contact solve: strict
    torch.testing.assert_close(out_k.geom_pos, out_p.geom_pos, rtol=1e-5,
                               atol=1e-5)

    # times at these shapes (grounded, implicit PD on)
    layout = CP.check_supported(model, sim, terrain=terrain)
    win = None if window is None else window(state)
    gt = (None if terrain is None else CP.geom_terrain_at(
        model, sim, layout, state, terrain, win))
    if terrain is not None and sloped:
        # contact happens on the terrain's slopes, not only on flat cells
        on_slope = (gt[1][..., 2] < 0.999) & (
            out_p.geom_pos[..., 2] - gt[0] < 0.05)
        say(phase, f"grounded geoms within 5 cm of a sloped surface: "
            f"{int(on_slope.sum())}")
        if int(on_slope.sum()) == 0:
            raise AssertionError("no geom near a sloped surface")
    cst = CP.KERNEL.table(model, sim, layout, state.q.device, boxes)
    x = CP.pack_inputs(model, state, tau, params, imp, terrain, gt, origins)
    y = torch.empty((CP.out_channels(model), n), device=state.q.device)
    has_t, has_w = terrain is not None, boxes is not None
    legacy = CP.legacy_contact(sim)

    def launch(xx, yy):
        CP.KERNEL.launch_packed(xx, yy, cst, layout, True, has_t, has_w,
                                legacy, fixed_base)
    result["ms"] = time_ms(lambda: launch(x, y), 50)
    # the same input again: the same bits (no atomics, every sum in a fixed
    # order; a race between lanes shows here only where two launches
    # resolve it differently)
    y2 = torch.empty_like(y)
    launch(x, y2)
    torch.cuda.synchronize()
    if not torch.equal(y, y2):
        raise AssertionError(f"two launches on one input differ in "
                             f"{int((y != y2).sum())} entries")
    # at the HLP's width as well: how the time scales with the envs
    if n > N_HLP:
        x1 = x[:, :N_HLP].contiguous()
        y1 = torch.empty((y.shape[0], N_HLP), device=y.device)
        result["ms_1024"] = time_ms(lambda: launch(x1, y1), 50)
    else:
        result["ms_1024"] = result["ms"]
    result["plain_ms"] = time_ms(
        lambda: physics_step_soa(model, sim, state, tau, params,
                                 terrain=terrain, implicit_damp=imp,
                                 terrain_window=win, world_boxes=boxes,
                                 env_origin=origins, fixed_base=fixed_base),
        plain_reps)
    ops = count_ops_per_env(model, sim, terrain=has_t, world=has_w,
                            fixed_base=fixed_base)
    nbytes = (x.numel() + y.numel() + cst.numel()) * 4
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops * n / H100_FP32_OPS_PER_S * 1e3
    result.update(
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        ops_per_env=ops, bytes=nbytes, c_in=x.shape[0], c_out=y.shape[0])
    say(phase, f"two launches on one input: bitwise equal; times N={n}: "
        f"kernel {result['ms']:.4f} ms/launch ({result['ms_1024']:.4f} at "
        f"N={min(n, N_HLP)}), plain {result['plain_ms']:.1f} ms/call, bound "
        f"{result['bound_ms']:.4f} ms by {result['bound_by']} "
        f"({ops:.0f} ops/env, {nbytes} bytes, C_in {x.shape[0]}, "
        f"C_out {y.shape[0]})")
    return result


def phase_kernel(dev, phase="kernel", model=None, sim=None,
                 make=random_inputs, fixed_base=False, plain_reps=2):
    """The plane variant on Go1 at 4096 envs; with ``model``, ``sim``
    (its contact model), ``make`` (its inputs) and ``fixed_base`` another
    variant on the plane."""
    if model is None:
        cfg, model = go1_model()
        sim = cfg.sim
    return hold_kernel(
        phase, model, sim,
        lambda seed, air: make(model, N_ENVS, seed, air, dev), N_ENVS,
        fixed_base=fixed_base, plain_reps=plain_reps)


def mix_grid(phase, dev):
    """The collision grid of the default TerrainCfg mix (slopes, stairs,
    obstacles) on the card."""
    from rapid_locomotion_rl_tpu_torch.config import TerrainCfg
    from rapid_locomotion_rl_tpu_torch.envs.terrain import Terrain
    t = time.time()
    tc = TerrainCfg()
    terrain = Terrain(tc, N_MC, seed=SEED)
    grid = terrain.as_collision_grid(
        tc.static_friction, tc.dynamic_friction, tc.restitution,
        upsample=tc.collision_upsample, slope_threshold=tc.slope_treshold,
        device=dev)
    say(phase, f"default TerrainCfg mix {tc.num_rows} x {tc.num_cols} "
        f"cells, collision grid {tuple(grid.height.shape)}, heights "
        f"[{grid.height.min().item():.3f}, {grid.height.max().item():.3f}] m, "
        f"built in {time.time() - t:.2f}s")
    return tc, grid


def phase_terrain(dev, tc, grid, phase="terrain", legacy=False,
                  fixed_base=False, model=None, make=random_inputs, n=N_MC,
                  plain_reps=2):
    """The terrain variant on Mini Cheetah at 4000 envs over the default
    TerrainCfg mix, looked up through the env's column-block window; with
    ``legacy`` the legacy-contact variant, with ``fixed_base`` also the
    fixed base, held and timed on the same states. ``model`` (with its
    ``make`` of inputs, at ``n`` envs) takes another robot's place."""
    import copy
    import numpy as np
    import torch
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.ops.contact import (
        blocked_window, terrain_height_bilinear)
    cfg, mc = robot(config_mini_cheetah)
    model = model or mc
    sim = copy.deepcopy(cfg.sim)
    if legacy:
        sim.contact_model = "legacy"
    rng = np.random.default_rng(SEED)
    xy = torch.tensor(np.stack([
        rng.uniform(0.5, tc.num_rows * tc.terrain_length - 0.5, n),
        rng.uniform(0.5, tc.num_cols * tc.terrain_width - 0.5, n)], -1),
        dtype=torch.float32, device=dev)
    under = terrain_height_bilinear(grid, xy[:, 0], xy[:, 1])

    def make_inputs(seed, airborne):
        state, tau, params, imp = make(model, n, seed, airborne, dev)
        pos = torch.cat([xy, state.base_pos[:, 2:] + under[:, None]], -1)
        return state._replace(base_pos=pos), tau, params, imp

    return hold_kernel(
        phase, model, sim, make_inputs, n, terrain=grid,
        window=lambda s: blocked_window(grid, s.base_pos[:, 0],
                                        s.base_pos[:, 1]),
        fixed_base=fixed_base, plain_reps=plain_reps)


def hold_in_walls(phase, out_k, out_p, wall):
    """The in-wall flight by the CPU tests' rule for states in the walls
    (tests/torch_port_helpers.py::assert_step_close_walls): the envs with
    a wall force (``wall`` [N, nr, 3]) at 2e-5 on >= 99% of each state
    field's entries and 2e-4 / 2e-3 on >= 99% of their wall-force
    entries, and every entry within the grounded bulk tolerances; the
    envs clear of the walls at 2e-5 strictly. Returns the state's max
    |err|."""
    import torch
    walled = wall.flatten(1).any(1)
    err = 0.0
    for name in out_p.state._fields:
        a, b = getattr(out_k.state, name), getattr(out_p.state, name)
        if not torch.isfinite(a).all():
            raise AssertionError(f"wall flight {name}: non-finite output")
        torch.testing.assert_close(a[~walled], b[~walled], rtol=2e-5,
                                   atol=2e-5, msg=lambda m: f"wall flight "
                                   f"{name}, envs clear of the walls: {m}")
        strict = ((a[walled] - b[walled]).abs()
                  <= 2e-5 + 2e-5 * b[walled].abs()).float().mean().item()
        if not strict >= 0.99:
            raise AssertionError(f"wall flight {name}: {strict:.4f} < 0.99 "
                                 f"of the walled envs' entries at 2e-5")
        atol = 1e-2 if name in ("qd", "base_lin_vel", "base_ang_vel") else 1e-3
        mostly_close(phase, f"{name} (envs in the walls)", a[walled],
                     b[walled], atol, label="wall flight", frac=1.0)
        err = max(err, (a - b).abs().max().item())
    ka, pa = out_k.contact_report[wall], out_p.contact_report[wall]
    close = (ka - pa).abs() <= 2e-3 + 2e-4 * pa.abs()
    if not close.float().mean().item() >= 0.99:
        raise AssertionError(f"wall flight: wall forces agree on "
                             f"{close.float().mean().item():.4f} < 0.99")
    mostly_close(phase, "wall forces", ka, pa, 0.5, label="wall flight",
                 frac=1.0)
    return err


def phase_world(dev, tc, grid, n, phase, legacy=False, fixed_base=False,
                hopper=False, plain_reps=2, config=None, wall_rule="strict"):
    """The terrain + world variant on Mini Cheetah at ``n`` envs over the
    default TerrainCfg mix, in the default corridor (4 walls 1 m high
    around 3.5 x 1.6 m), each env's origin on the ground under its base,
    the base at x in [-1.95, 1.95] and |y| in [0.45, 0.95] from the origin,
    so that spheres clear, touch, cross and sit inside the walls. With
    ``grid`` None the same on the plane; ``legacy`` and ``fixed_base``
    pick those variants; with ``hopper`` the 1 x 2 hopper in the JAX
    tests' 1.2 x 0.5 m corridor (bases at |x| <= 0.68, |y| in [0.12,
    0.3], flight in the walls at 0.5 m); ``config`` another quadruped's
    (config_go1 for the plane variants). With ``wall_rule`` "bulk" the
    flight in the walls is held by :func:`hold_in_walls`.

    Flight over the walls (2 m up, torque-free: the world branch runs and
    adds nothing) is held strictly, grounded states (~0.3 m up, random
    torques) in bulk, as for the other variants. Flight at 0.75 m, inside
    the walls' height, touches the walls (and, on steep cells, some
    ground): its state is held at rtol/atol 2e-5 and the report entries
    that the walls change at 2e-4/2e-3. That holds because the kernel and
    the plain version take the same sin and cos on the card: the walls'
    30000 N/m turn a last-place difference in a sphere's position into
    ~0.01 N, which moves the fastest joints of the states deepest in a
    wall by more than 2e-5 (as between the g++ build and PyTorch on the
    CPU). ``max_abs_err`` is the larger of the two flights' state errors
    (the one in the walls, where the world branch acts, in practice)."""
    import copy
    import numpy as np
    import torch
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    from rapid_locomotion_rl_tpu_torch.ops.contact import (
        blocked_window, terrain_height_bilinear)
    from rapid_locomotion_rl_tpu_torch.ops.soa_physics import physics_step_soa
    from rapid_locomotion_rl_tpu_torch.ops.world import default_corridor
    cfg, model = robot(config or config_mini_cheetah)
    sim = copy.deepcopy(cfg.sim)
    if legacy:
        sim.contact_model = "legacy"
    make, lift_in, rel_x, rel_y = random_inputs, 0.75, 1.95, (0.45, 0.95)
    boxes = default_corridor(cfg.world.length, cfg.world.width,
                             cfg.world.wall_height, cfg.world.wall_thickness)
    if hopper:
        _, model = hopper_model()
        make, lift_in, rel_x, rel_y = hopper_inputs, 0.5, 0.68, (0.12, 0.3)
        boxes = default_corridor(1.2, 0.5, wall_height=1.0)
    rng = np.random.default_rng(SEED + 1)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    xy = f(np.stack([
        rng.uniform(2.5, tc.num_rows * tc.terrain_length - 2.5, n),
        rng.uniform(2.5, tc.num_cols * tc.terrain_width - 2.5, n)], -1))
    rel = f(np.stack([rng.uniform(-rel_x, rel_x, n),
                      rng.choice([-1.0, 1.0], n)
                      * rng.uniform(*rel_y, n)], -1))
    under = (torch.zeros(n, device=dev) if grid is None else
             terrain_height_bilinear(grid, xy[:, 0], xy[:, 1]))
    origins = torch.cat([xy - rel, under[:, None]], -1).contiguous()

    def make_inputs(seed, airborne, lift=None):
        """Flight 2 m up by default: over the 1 m walls."""
        state, tau, params, imp = make(model, n, seed, airborne, dev)
        lift = 2.0 if airborne and lift is None else lift
        z = state.base_pos[:, 2] if lift is None else 0.0 * under + lift
        pos = torch.cat([xy, (z + under)[:, None]], -1)
        return state._replace(base_pos=pos), tau, params, imp

    def window(s):
        return (None if grid is None else
                blocked_window(grid, s.base_pos[:, 0], s.base_pos[:, 1]))

    def both(state, tau, params, imp, walls=True):
        kw = dict(terrain=grid, implicit_damp=imp, terrain_window=window(state),
                  world_boxes=boxes if walls else None,
                  env_origin=origins if walls else None,
                  fixed_base=fixed_base)
        out_k = (CP.physics_step_cuda(model, sim, state, tau, params, **kw)
                 if walls else None)
        torch.cuda.synchronize()
        if walls and fixed_base:
            check_pinned(phase, state, out_k)
        return out_k, physics_step_soa(model, sim, state, tau, params, **kw)

    # where the spheres are against the walls, at the grounded entry state
    _, out_p = both(*make_inputs(0, False))
    gp = out_p.geom_pos
    rad = torch.tensor(np.asarray(model.geom_radius, np.float32), device=dev)
    r = gp[:, :, None, :] - (origins[:, None, None, :] + boxes.centers.to(dev))
    h = boxes.half_extents.to(dev)
    d = (r.abs() - h).clamp_min(0.0).norm(dim=-1)
    inside = (r.abs() <= h).all(-1).any(-1)
    touching = ((d > 0) & (d < rad[None, :, None])).any(-1) & ~inside
    say(phase, f"grounded geoms: {int(inside.sum())} centers inside a "
        f"wall, {int(touching.sum())} touching or crossing one, of "
        f"{gp.shape[0] * gp.shape[1]}")
    if int(inside.sum()) == 0 or int(touching.sum()) == 0:
        raise AssertionError("the states do not reach into the walls")

    # flight inside the walls' height (a few feet reach steep ground)
    walled = make_inputs(3, True, lift=lift_in)
    _, free = both(*walled, walls=False)
    out_k, out_p = both(*walled)
    wall = out_p.contact_report != free.contact_report
    if int(wall.sum()) == 0:
        raise AssertionError("flight in the walls: no wall force")
    if wall_rule == "bulk":
        err = hold_in_walls(phase, out_k, out_p, wall)
    else:
        err = 0.0
        for name in out_p.state._fields:
            a, b = getattr(out_k.state, name), getattr(out_p.state, name)
            if not torch.isfinite(a).all():
                raise AssertionError(f"wall flight {name}: non-finite "
                                     f"output")
            torch.testing.assert_close(
                a, b, rtol=2e-5, atol=2e-5,
                msg=lambda m: f"wall flight {name}: {m}")
            err = max(err, (a - b).abs().max().item())
        torch.testing.assert_close(out_k.contact_report[wall],
                                   out_p.contact_report[wall], rtol=2e-4,
                                   atol=2e-3)
    rep_err = (out_k.contact_report - out_p.contact_report)[wall].abs().max()
    say(phase, f"flight in the walls: state max |err| {err:.3g} (rtol/atol"
        f" 2e-5); {int(wall.sum())} wall-force entries (max |f| "
        f"{out_p.contact_report.abs().max().item():.4g} N) within rtol 2e-4"
        f" / atol 2e-3 (max |err| {rep_err.item():.3g} N)")
    result = hold_kernel(
        phase, model, sim, make_inputs, n, terrain=grid,
        window=None if grid is None else window, boxes=boxes,
        origins=origins, fixed_base=fixed_base, plain_reps=plain_reps)
    result.update(wall_entries_flight=int(wall.sum()),
                  flight_over_walls_err=result["max_abs_err"],
                  flight_in_walls_err=err,
                  max_abs_err=max(err, result["max_abs_err"]))
    return result


def load_run(env, weights, dev):
    """The policy of a training run (its parameters.json and weights) on
    the card, and the run's PPO arguments."""
    from rapid_locomotion_rl_tpu_torch.convert import params_from_flax
    from rapid_locomotion_rl_tpu_torch.learn.ppo import PPOArgs
    from rapid_locomotion_rl_tpu_torch.models.networks import ACArgs, ActorCritic
    from rapid_locomotion_rl_tpu_torch.utils.checkpoint import load_pytree
    with open(os.path.join(os.path.dirname(os.path.dirname(weights)),
                           "parameters.json")) as f:
        run = json.load(f)
    ac = ActorCritic(env.num_obs, env.num_privileged_obs,
                     env.num_obs_history, env.num_actions,
                     ACArgs(**run["AC_Args"])).to(dev)
    ac.load_state_dict(params_from_flax(load_pytree(weights)["params"]))
    return ac, PPOArgs(**run.get("PPO_Args", {}))


# K1's variants built for the card, (D, K, terrain, walls, legacy, fixed
# base), by their short names in this script: the five held by phases 3-7
# first, then the rest of ops/cuda_physics.CUDA_VARIANTS
VARIANT_OF = {
    "plane": (3, 4, 0, 0, 0, 0), "terrain": (3, 4, 1, 0, 0, 0),
    "world": (3, 4, 1, 1, 0, 0), "legacy": (3, 4, 1, 0, 1, 0),
    "fixed_base": (3, 4, 1, 0, 1, 1),
    "plane_legacy": (3, 4, 0, 0, 1, 0),
    "plane_legacy_fixed_base": (3, 4, 0, 0, 1, 1),
    "plane_world": (3, 4, 0, 1, 0, 0),
    "plane_world_legacy": (3, 4, 0, 1, 1, 0),
    "plane_world_legacy_fixed_base": (3, 4, 0, 1, 1, 1),
    "terrain_world_legacy": (3, 4, 1, 1, 1, 0),
    "terrain_world_legacy_fixed_base": (3, 4, 1, 1, 1, 1),
    **{"1x2_" + ("terrain" if t else "plane") + ("_world" if w else "")
       + ("_legacy" if leg else "") + ("_fixed_base" if fix else ""):
       (1, 2, t, w, leg, fix)
       for t in (0, 1) for w in (0, 1)
       for leg, fix in ((0, 0), (1, 0), (1, 1))},
}
VARIANTS = tuple(VARIANT_OF)
NEW_3X4 = VARIANTS[5:12]          # ported in this slice, quadruped layout
HOPPER = VARIANTS[12:]            # the test hopper's 1 x 2 layout


def zero_counts():
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    CP.KERNEL.zero_counts()


def read_counts():
    """Launches per variant since zero_counts, in the order of VARIANTS."""
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    got = CP.KERNEL.variant_launches
    return tuple(got.get(VARIANT_OF[v], 0) for v in VARIANTS)


def check_counts(phase, got, **want):
    """``got`` (read_counts or a difference of two) has ``want`` launches
    of the named variants and none of the others."""
    exp = tuple(want.get(v, 0) for v in VARIANTS)
    if tuple(got) != exp:
        raise AssertionError(f"{phase}: launches per variant "
                             f"{dict(zip(VARIANTS, got))}, want "
                             f"{dict(zip(VARIANTS, exp))}")


def phase_rollout(dev):
    import torch
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.learn.ppo import PPOArgs, rollout
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    cfg, _ = go1_model()
    if cfg.env.num_envs != N_ENVS:
        raise AssertionError(f"config_go1 has {cfg.env.num_envs} envs")
    t = time.time()
    env = LeggedRobotEnv(cfg, device=dev)
    ac, _ = load_run(env, WEIGHTS, dev)
    sampler = Sampler(SEED, dev)
    state = env.initial_state(sampler)
    torch.cuda.synchronize()
    say("rollout", f"Go1 env ({env.num_envs} envs, nv={env.model.nv}, "
        f"ng={env.model.ng}, nr={env.model.nr}) and {WEIGHTS} loaded in "
        f"{time.time() - t:.2f}s")

    # the main path: one PPO horizon through the kernel
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = time.time()
    state, traj, info = rollout(env, ac, PPOArgs(), state, sampler, HORIZON)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = read_counts()[0]
    check_counts("rollout", read_counts(),
                 plane=HORIZON * cfg.control.decimation)
    for name, v in list(traj._asdict().items()) + list(info.items()) + \
            list(state.sim._asdict().items()):
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise AssertionError(f"rollout output {name} is not finite")
    if tuple(traj.obs.shape) != (HORIZON, N_ENVS, env.num_obs):
        raise AssertionError(f"obs shape {tuple(traj.obs.shape)}")
    # a trained policy keeps the robots up: base height and resets
    z = state.sim.base_pos[:, 2].mean().item()
    done = traj.dones.float().mean().item()
    if not (0.15 < z < 0.5 and done < 0.05):
        raise AssertionError(f"robots fell: mean base z {z:.3f}, "
                             f"done rate {done:.4f}")
    peak = torch.cuda.max_memory_allocated()

    # steady state: a second horizon, and the kernel alone on its inputs
    t = time.time()
    state, traj, info = rollout(env, ac, PPOArgs(), state, sampler, HORIZON)
    torch.cuda.synchronize()
    wall2 = time.time() - t
    layout = CP.check_supported(env.model, cfg.sim)
    params, imp, _ = env.physics_inputs(state)
    x = CP.pack_inputs(env.model, state.sim, state.torques, params, imp)
    y = torch.empty((CP.out_channels(env.model), N_ENVS), device=dev)
    cst = CP.KERNEL.table(env.model, cfg.sim, layout, dev)
    k_ms = time_ms(lambda: CP.KERNEL.launch_packed(x, y, cst, layout, True),
                   50)
    card = card_line()
    say("rollout", f"{HORIZON} steps x {N_ENVS} envs: {launches} kernel "
        f"launches; mean reward {traj.rewards.mean().item():.5f}, base z "
        f"{z:.3f} m, done rate {done:.4f}")
    say("rollout", f"env-steps/s {HORIZON * N_ENVS / wall:.0f} (first "
        f"horizon, {wall:.3f}s), {HORIZON * N_ENVS / wall2:.0f} (second, "
        f"{wall2:.3f}s); kernel {k_ms:.4f} ms/launch on the rollout state "
        f"({k_ms * cfg.control.decimation / (wall2 / HORIZON * 1e3) * 100:.1f}"
        f"% of a step); peak memory {peak / 2**20:.1f} MiB | {card}")
    return dict(launches=launches, env_steps_per_s=HORIZON * N_ENVS / wall2,
                kernel_ms_rollout=k_ms, peak_bytes=peak)


def phase_horizon(dev, phase, fixed_base):
    """config_mini_cheetah (4000 envs, trimesh) with the legacy contact
    model, and with ``fixed_base`` a fixed base, under the runs/r5_flagship
    policy for one 24-step horizon: every physics call through that
    variant, the state finite. With the fixed base the kernel returns each
    input base pose unchanged and zero base velocities, and a base moves
    only when its env resets. Returns the variant's launches."""
    import torch
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.learn.ppo import PPOArgs, rollout
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    cfg = config_mini_cheetah()
    cfg.sim.contact_model = "legacy"
    cfg.asset.fix_base_link = fixed_base
    t = time.time()
    env = LeggedRobotEnv(cfg, device=dev)
    ac, _ = load_run(env, MC_WEIGHTS, dev)
    sampler = Sampler(SEED, dev)
    state = env.initial_state(sampler)
    torch.cuda.synchronize()
    say(phase, f"flagship env (legacy contact, fix_base_link={fixed_base}, "
        f"{env.num_envs} envs) and {MC_WEIGHTS} loaded in "
        f"{time.time() - t:.2f}s")
    moved = [0]
    if fixed_base:
        phys, step = env._phys, env.step

        def pinned(sim, *args):
            out = phys(sim, *args)
            check_pinned(phase, sim, out)
            return out

        def stepped(st, actions, smp):
            new, res = step(st, actions, smp)
            same = ((new.sim.base_pos == st.sim.base_pos).all(-1)
                    & (new.sim.base_quat == st.sim.base_quat).all(-1))
            moved[0] += int((~res.done & ~same).sum())
            return new, res
        env._phys, env.step = pinned, stepped

    zero_counts()
    t = time.time()
    state, traj, info = rollout(env, ac, PPOArgs(), state, sampler, HORIZON)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = read_counts()
    name = "fixed_base" if fixed_base else "legacy"
    check_counts(phase, counts,
                 **{name: HORIZON * cfg.control.decimation})
    for k, v in list(traj._asdict().items()) + list(info.items()) + \
            list(state.sim._asdict().items()):
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise AssertionError(f"{phase}: {k} is not finite")
    if moved[0]:
        raise AssertionError(f"{phase}: {moved[0]} bases moved without a "
                             f"reset")
    say(phase, f"{HORIZON} steps x {env.num_envs} envs: "
        f"{counts[VARIANTS.index(name)]} {name}-variant launches, state "
        f"finite; mean base z {state.sim.base_pos[:, 2].mean().item():.3f} "
        f"m, done rate {traj.dones.float().mean().item():.4f}, mean reward "
        f"{traj.rewards.mean().item():.5f}; {wall:.3f}s "
        f"({HORIZON * env.num_envs / wall:.0f} env-steps/s)"
        + ("; every base where its last reset put it" if fixed_base
           else "") + f" | {card_line()}")
    return counts[VARIANTS.index(name)]


def phase_variant(dev, tc, grid, phase, fixed_base):
    """K1's legacy-contact variant (with ``fixed_base`` the fixed-base one)
    held and timed at 4000 envs over the mix, then driven through the
    flagship env for a horizon."""
    k = phase_terrain(dev, tc, grid, phase, legacy=True,
                      fixed_base=fixed_base)
    k["launches"] = phase_horizon(dev, phase, fixed_base)
    return k


def phase_variants(dev, tc, grid):
    """K1's variants new in this slice, each against its plain version by
    the rules of the variant it extends (phase_kernel, phase_terrain,
    phase_world, the fixed base checked exactly), timed at its width and at
    1024 envs: the quadruped's plane variants on Go1 at config_go1's 4096
    envs, its terrain variants on Mini Cheetah at the flagship's 4000 over
    the mix; the hopper's twelve at 4096. Their flight in the walls is held
    by the CPU tests' rule for states in a wall (:func:`hold_in_walls`),
    not strictly as the ``world`` phase holds Mini Cheetah's: the walls'
    30,000 N/m turn a last-place difference in a sphere's position into
    ~0.01 N, and with Go1's 57 spheres a few entries of qd of 49,152 come
    out past 2e-5 relative on the H100 (4.2e-5 measured). Returns
    {variant: result}."""
    import copy
    from rapid_locomotion_rl_tpu_torch.config import config_go1
    out = {}
    go1_cfg, go1 = go1_model()
    hop_cfg, hop = hopper_model()
    for v in NEW_3X4 + HOPPER:
        t = time.time()
        D, K, ter, wld, leg, fix = VARIANT_OF[v]
        hopper = (D, K) == (1, 2)
        if wld:
            k = phase_world(dev, tc, grid if ter else None,
                            N_MC if ter and not hopper else N_ENVS, v,
                            legacy=bool(leg), fixed_base=bool(fix),
                            hopper=hopper, plain_reps=1,
                            config=None if ter else config_go1,
                            wall_rule="bulk")
        elif ter:
            k = phase_terrain(dev, tc, grid, v, legacy=bool(leg),
                              fixed_base=bool(fix),
                              model=hop if hopper else None,
                              make=hopper_inputs if hopper else random_inputs,
                              n=N_ENVS if hopper else N_MC, plain_reps=1)
        else:
            model, cfg = (hop, hop_cfg) if hopper else (go1, go1_cfg)
            sim = copy.deepcopy(cfg.sim)
            sim.contact_model = "legacy" if leg else "apparent"
            k = phase_kernel(dev, v, model, sim,
                             hopper_inputs if hopper else random_inputs,
                             bool(fix), plain_reps=1)
        out[v] = k
        say(v, f"held in {time.time() - t:.1f}s | {card_line()}")
    return out


def train_iterations(phase, env, weights, variant):
    """ITERATIONS iterations of learn/ppo.py::train_iteration through
    ``env`` under the policy of ``weights`` (its PPO arguments, fresh Adam
    states), counts zeroed just before: every physics call through
    ``variant``; losses, KL, LR, parameters and the state finite. Returns
    the variant's launches and the last iteration's split."""
    import numpy as np
    import torch
    from rapid_locomotion_rl_tpu_torch.learn.ppo import (init_ppo_state,
                                                         train_iteration)
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    ac, ppo_args = load_run(env, weights, dev=env.device)
    ppo_state = init_ppo_state(ac, ppo_args)
    sampler = Sampler(SEED, env.device)
    state = env.initial_state(sampler)
    torch.cuda.synchronize()
    zero_counts()
    for it in range(ITERATIONS):
        tm = {}
        state, ppo_state, m = train_iteration(
            env, ac, ppo_args, state, ppo_state, sampler, num_steps=HORIZON,
            timings=tm)
        m = {k: float(v) for k, v in m.items()
             if not k.startswith("_render/") and v.numel() == 1}
        for k in ("mean_value_loss", "mean_surrogate_loss",
                  "mean_adaptation_loss", "kl", "lr", "mean_reward"):
            if not np.isfinite(m[k]):
                raise AssertionError(f"{phase} iteration {it}: {k} = {m[k]}")
        total = tm["rollout_s"] + tm["update_s"]
        say(phase, f"iteration {it}: rollout {tm['rollout_s']:.3f}s, update "
            f"{tm['update_s']:.3f}s, {HORIZON * env.num_envs / total:.0f} "
            f"env-steps/s; value loss {m['mean_value_loss']:.4g}, kl "
            f"{m['kl']:.4g}, lr {m['lr']:.4g}, mean reward "
            f"{m['mean_reward']:.5f}, done rate "
            f"{m['mean_episode_dones']:.4f}")
    counts = read_counts()
    check_counts(phase, counts, **{
        variant: ITERATIONS * HORIZON * env.cfg.control.decimation})
    if not all(torch.isfinite(p).all() for p in ac.parameters()):
        raise AssertionError(f"{phase}: non-finite parameters")
    finite_state(phase, state)
    n = counts[VARIANTS.index(variant)]
    say(phase, f"{ITERATIONS} iterations x {HORIZON} steps x "
        f"{env.num_envs} envs: {n} {variant}-variant launches, no other; "
        f"mean base z {state.sim.base_pos[:, 2].mean().item():.3f} m | "
        f"{card_line()}")
    return dict(launches=n, env_steps_per_s=HORIZON * env.num_envs / total)


def phase_go1_legacy(dev):
    """config_go1 (4096 envs, the plane) with sim.contact_model "legacy",
    as a user's config sets it, under the runs/r4_go1 policy: two training
    iterations through K1's plane + legacy variant."""
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
    cfg, _ = go1_model()
    cfg.sim.contact_model = "legacy"
    env = LeggedRobotEnv(cfg, device=dev)
    return train_iterations("go1-legacy", env, WEIGHTS, "plane_legacy")


def phase_corridor_legacy(dev):
    """config_mini_cheetah (4000 envs, trimesh) with the corridor's walls
    (world.enabled) and the legacy contact model, under the runs/
    r5_flagship policy: two training iterations through K1's terrain +
    world + legacy variant."""
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
    cfg = config_mini_cheetah()
    cfg.world.enabled = True
    cfg.sim.contact_model = "legacy"
    env = LeggedRobotEnv(cfg, device=dev)
    return train_iterations("corridor-legacy", env, MC_WEIGHTS,
                            "terrain_world_legacy")


ENV_STEPS = 2


def phase_env_variants(dev):
    """The variants that no script's config reaches, each through the env
    built from a user's config (config_go1 on the plane, config_mini_cheetah
    on its trimesh, with the corridor's walls, the legacy contact model and
    a fixed base set as a user sets them): ENV_STEPS steps of the rollout
    under the run's policy, every physics call through the variant; then
    the hopper's twelve through ops/cuda_physics.physics_step_cuda, four
    calls each from a grounded state. Returns {variant: launches}."""
    import copy
    import torch
    from rapid_locomotion_rl_tpu_torch.config import (config_go1,
                                                      config_mini_cheetah)
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.learn.ppo import PPOArgs, rollout
    from rapid_locomotion_rl_tpu_torch.ops.contact import blocked_window
    from rapid_locomotion_rl_tpu_torch.ops.cuda_physics import \
        physics_step_cuda
    from rapid_locomotion_rl_tpu_torch.ops.world import default_corridor
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    out = {}
    for v in ("plane_world", "plane_legacy_fixed_base", "plane_world_legacy",
              "plane_world_legacy_fixed_base",
              "terrain_world_legacy_fixed_base"):
        t = time.time()
        _, _, ter, wld, leg, fix = VARIANT_OF[v]
        cfg = config_mini_cheetah() if ter else config_go1()
        cfg.world.enabled = bool(wld)
        cfg.sim.contact_model = "legacy" if leg else "apparent"
        cfg.asset.fix_base_link = bool(fix)
        env = LeggedRobotEnv(cfg, device=dev)
        ac, _ = load_run(env, MC_WEIGHTS if ter else WEIGHTS, dev)
        sampler = Sampler(SEED, dev)
        state = env.initial_state(sampler)
        zero_counts()
        state, traj, _ = rollout(env, ac, PPOArgs(), state, sampler,
                                 ENV_STEPS)
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(v, counts, **{v: ENV_STEPS * cfg.control.decimation})
        finite_state(v, state)
        if not torch.isfinite(traj.rewards).all():
            raise AssertionError(f"{v}: non-finite rewards")
        out[v] = counts[VARIANTS.index(v)]
        say(v, f"{ENV_STEPS} steps x {env.num_envs} envs of "
            f"{'config_mini_cheetah' if ter else 'config_go1'} (walls "
            f"{bool(wld)}, {cfg.sim.contact_model}, fix_base_link "
            f"{bool(fix)}): {out[v]} launches of the variant, no other, "
            f"finite; {time.time() - t:.1f}s")
    hop_cfg, hop = hopper_model()
    grid = None
    for v in HOPPER:
        _, _, ter, wld, leg, fix = VARIANT_OF[v]
        sim = copy.deepcopy(hop_cfg.sim)
        sim.contact_model = "legacy" if leg else "apparent"
        if ter and grid is None:
            _, grid = mix_grid(v, dev)
        state, tau, params, imp = hopper_inputs(hop, N_ENVS, 5, False, dev)
        origin = torch.zeros((N_ENVS, 3), device=dev)
        kw = dict(fixed_base=bool(fix), implicit_damp=imp)
        if ter:   # over the mix, 40 m in
            origin[:, :2] = 40.0
            state = state._replace(base_pos=state.base_pos + origin)
            kw.update(terrain=grid, terrain_window=blocked_window(
                grid, state.base_pos[:, 0], state.base_pos[:, 1]))
        if wld:
            kw.update(world_boxes=default_corridor(1.2, 0.5, wall_height=1.0),
                      env_origin=origin)
        zero_counts()
        for _ in range(4):
            state = physics_step_cuda(hop, sim, state, tau, params,
                                      **kw).state
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(v, counts, **{v: 4})
        if not all(torch.isfinite(x).all() for x in state):
            raise AssertionError(f"{v}: the hopper's state is not finite")
        out[v] = counts[VARIANTS.index(v)]
    say("env-variants", f"the hopper's 12 variants: 4 calls each of "
        f"physics_step_cuda at {N_ENVS} envs through its variant, finite | "
        f"{card_line()}")
    return out


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sharded_worker(rank, world, port, out, device="cuda:0"):
    """One rank of the ``sharded`` phase (``chip_smoke.py --sharded-rank R
    --world W --port P --out F``): the flagship runner of
    scripts/train_cuda.py resumed from runs/r5_flagship on ``device``, its
    env
    axis split over W gloo ranks (W 1: one process, unsplit), one training
    iteration of learn/ppo.py::train_iteration; rank 0 saves the metrics,
    parameters, LR, curriculum weights and wall times to F."""
    import torch
    import torch.distributed as dist
    from rapid_locomotion_rl_tpu_torch.learn.ppo import train_iteration
    from rapid_locomotion_rl_tpu_torch.parallel.sharding import \
        make_sharded_runner_placement
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if world > 1:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
    mod = script("train_cuda.py")
    runner = mod.build_runner(mod.parse_args(
        ["--resume", MC_STATE, "--logdir", run_dir(f"sharded-{world}-{rank}"),
         "--device", str(device)]))
    if world > 1:
        make_sharded_runner_placement(runner)
    coef = float(runner.ppo_args.entropy_coef)   # past the warm-up
    torch.cuda.synchronize()
    t = time.time()
    tm = {}
    state, ppo_state, m = train_iteration(
        runner.env, runner.ac, runner.ppo_args, runner.env_state,
        runner.ppo_state, runner.sampler, entropy_coef=coef,
        num_steps=runner.args.num_steps_per_env, timings=tm)
    torch.cuda.synchronize()
    wall = time.time() - t
    if rank == 0:
        torch.save(dict(
            metrics={k: v.detach().cpu() for k, v in m.items()
                     if not k.startswith("_render/")},
            params={k: v.detach().cpu()
                    for k, v in runner.ac.state_dict().items()},
            lr=ppo_state.lr, weights=state.curriculum.weights.cpu(),
            wall=wall, **tm), out)
    if world > 1:
        dist.destroy_process_group()


# the command of a sharded_worker process
WORKER_CMD = [sys.executable, os.path.abspath(__file__)]


def run_ranks(world, tag, dev, timeout=600):
    """``world`` sharded_worker processes at once; rank 0's results."""
    import torch
    port = free_port()
    out = os.path.join(run_dir(f"sharded-{tag}"), "rank0.pt")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    procs = [subprocess.Popen(
        WORKER_CMD + ["--sharded-rank", str(r), "--world", str(world),
                      "--port", str(port), "--out", out, "--device",
                      str(dev)])
        for r in range(world)]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise AssertionError(f"sharded {tag}: exit codes {rcs}")
    return torch.load(out, weights_only=False)


def phase_sharded(dev):
    """Data parallelism (parallel/sharding.py) on the card. (a)
    scripts/train_cuda.py --distributed --mesh data --iterations 2 in one
    NCCL process (torchrun's variables, a world of one): exit 0, the
    sharding line, one checkpoint. (b) One flagship iteration resumed from
    runs/r5_flagship at 4000 envs, in one process on the card, then over
    two gloo processes on the same card (2 x 2000 envs; NCCL takes one
    rank per card): KL and value loss at rtol 1e-3 / atol 1e-5, the
    actor's first bias (the leaf of tests/test_sharding.py) at rtol 1e-4 /
    atol 1e-6 and every leaf on >= 99.9% of its entries (Adam's step on a
    near-zero gradient), the LR and the curriculum weights equal; the wall
    times of both."""
    import torch
    t = time.time()
    logdir = run_dir("sharded-nccl")
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    proc = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "scripts", "train_cuda.py"),
         "--distributed", "--mesh", "data", "--iterations",
         str(ITERATIONS), "--logdir", logdir, "--device", str(dev)],
        env=env, capture_output=True,
        text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"train_cuda.py --distributed: exit "
                             f"{proc.returncode}\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    line = "sharding env axis over 1 devices (1 process(es))"
    ckpt = os.path.join(logdir, "checkpoints", "train_state_last.pkl")
    if line not in proc.stdout or not os.path.exists(ckpt):
        raise AssertionError(f"train_cuda.py --distributed: no sharding "
                             f"line or checkpoint:\n{proc.stdout[-3000:]}")
    say("sharded", f"(a) train_cuda.py --distributed --mesh data, NCCL, "
        f"world 1: exit 0, '{line}', {ITERATIONS} iterations, "
        f"{os.path.basename(ckpt)} written; {time.time() - t:.1f}s")

    one = run_ranks(1, "one", dev)
    two = run_ranks(2, "two", dev)
    for k in ("kl", "mean_value_loss"):
        a, b = two["metrics"][k], one["metrics"][k]
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5,
                                   msg=lambda m: f"sharded {k}: {m}")
    if two["lr"] != one["lr"]:
        raise AssertionError(f"sharded lr {two['lr']} != {one['lr']}")
    if not torch.equal(two["weights"], one["weights"]):
        raise AssertionError("sharded: the curriculum weights differ")
    leaf = "actor_body.layers.0.bias"
    torch.testing.assert_close(two["params"][leaf], one["params"][leaf],
                               rtol=1e-4, atol=1e-6)
    worst = 1.0
    for k, a in one["params"].items():
        close = (two["params"][k] - a).abs() <= 1e-6 + 1e-4 * a.abs()
        worst = min(worst, close.float().mean().item())
    if worst < 0.999:
        raise AssertionError(f"sharded: a leaf agrees on {worst:.5f} only")
    rel = {k: abs(two["metrics"][k].item() / one["metrics"][k].item() - 1)
           for k in ("kl", "mean_value_loss", "mean_surrogate_loss",
                     "mean_reward")}
    say("sharded", f"(b) one flagship iteration at 4000 envs, 2 gloo ranks "
        f"x 2000 on cuda:0 against one process: kl {one['metrics']['kl']:.6g}"
        f" / {two['metrics']['kl']:.6g}, value loss "
        f"{one['metrics']['mean_value_loss']:.6g} / "
        f"{two['metrics']['mean_value_loss']:.6g}; relative differences "
        + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
        + f"; lr {one['lr']:.6g} equal, curriculum weights equal, {leaf} "
        f"within rtol 1e-4, every leaf >= {worst:.5f}; wall one process "
        f"{one['wall']:.3f}s (rollout {one['rollout_s']:.3f}, update "
        f"{one['update_s']:.3f}), two ranks {two['wall']:.3f}s (rollout "
        f"{two['rollout_s']:.3f}, update {two['update_s']:.3f}) | "
        f"{card_line()}")
    return dict(one=one["wall"], two=two["wall"], rel=rel, worst=worst)


def phase_train(dev):
    """scripts/train_cuda.py's main on the flagship (config_mini_cheetah,
    4000 envs, trimesh), resumed from runs/r5_flagship's full train state
    (params, both Adam states, LR, env state), ITERATIONS iterations into
    a scratch logdir."""
    import numpy as np
    import torch
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    mod = script("train_cuda.py")
    logdir = run_dir("train")
    argv = ["--resume", MC_STATE, "--iterations", str(ITERATIONS),
            "--logdir", logdir, "--device", str(dev)]
    say("train", "train_cuda.py " + " ".join(argv))
    seen = []
    build = mod.build_runner

    def build_and_watch(args):
        t = time.time()
        runner = build(args)
        torch.cuda.synchronize()
        grid = runner.env.collision_grid
        say("train", f"Mini Cheetah env ({runner.env.num_envs} envs, nv="
            f"{runner.env.model.nv}, ng={runner.env.model.ng}, nr="
            f"{runner.env.model.nr}), collision grid "
            f"{tuple(grid.height.shape)} "
            f"({grid.height.numel() * 4 / 2**20:.1f} MiB), and the resumed "
            f"state (iteration {runner.current_learning_iteration}, lr "
            f"{runner.ppo_state.lr:.6g}) loaded in {time.time() - t:.2f}s")
        if runner.current_learning_iteration != 4000:
            raise AssertionError(f"resumed at iteration "
                                 f"{runner.current_learning_iteration}")
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        log_iteration = runner._log_iteration

        def logged(it, metrics):
            log_iteration(it, metrics)
            seen.append((it, read_counts(), dict(runner.last_metrics),
                         runner.env_state.sim.base_pos[:, 2].mean().item()))
        runner._log_iteration = logged
        return runner

    mod.build_runner = build_and_watch
    try:
        runner = mod.main(argv)
    finally:
        mod.build_runner = build
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    env = runner.env
    cfg = env.cfg
    per_iter = runner.args.num_steps_per_env * cfg.control.decimation
    if len(seen) != ITERATIONS:
        raise AssertionError(f"{len(seen)} iterations logged")
    before = (0,) * len(VARIANTS)
    runs = []
    for (it, counts, m, z), tm in zip(seen, runner.timings):
        check_counts(f"train iteration {it}",
                     [a - b for a, b in zip(counts, before)],
                     terrain=per_iter)
        before = counts
        for k in ("mean_value_loss", "mean_surrogate_loss",
                  "mean_adaptation_loss", "kl", "lr", "mean_reward"):
            if not np.isfinite(m[k]):
                raise AssertionError(f"iteration {it}: {k} = {m[k]}")
        if not 0.003 <= m["kl"] <= 0.1:
            raise AssertionError(f"iteration {it}: kl {m['kl']} out of "
                                 f"[0.003, 0.1]")
        if not float(np.float32(1e-5)) < m["lr"] <= 1e-2:
            raise AssertionError(f"iteration {it}: lr {m['lr']} out of "
                                 f"(1e-5, 1e-2]")
        done = m["mean_episode_dones"]
        if not (0.15 < z < 0.5 and done < 0.05):
            raise AssertionError(f"robots fell: mean base z {z:.3f}, "
                                 f"done rate {done:.4f}")
        total = tm["rollout_s"] + tm["update_s"]
        steps = runner.args.num_steps_per_env * env.num_envs
        runs.append(dict(tm, total_s=total, env_steps_per_s=steps / total,
                         kl=m["kl"], lr=m["lr"]))
        say("train", f"iteration {it}: {per_iter} terrain-variant launches; "
            f"rollout {tm['rollout_s']:.3f}s, update {tm['update_s']:.3f}s "
            f"({tm['update_s'] / total:.1%} of {total:.3f}s), "
            f"{steps / total:.0f} env-steps/s; value loss "
            f"{m['mean_value_loss']:.4g}, surrogate "
            f"{m['mean_surrogate_loss']:.4g}, adaptation "
            f"{m['mean_adaptation_loss']:.4g}, kl {m['kl']:.4g}, lr "
            f"{m['lr']:.4g}, mean reward {m['mean_reward']:.5f}, base z "
            f"{z:.3f} m, done rate {done:.4f}")
    if not all(torch.isfinite(p).all() for p in runner.ac.parameters()):
        raise AssertionError("train: non-finite parameters")
    for name, v in runner.env_state.sim._asdict().items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"train: sim state {name} is not finite")
    got = metric_keys(os.path.join(logdir, "metrics.jsonl"))
    ref = metric_keys(os.path.join("runs", "r5_flagship", "metrics.jsonl"))
    if got != ref:
        raise AssertionError(f"metric keys differ from r5_flagship's: extra "
                             f"{sorted(got - ref)}, missing "
                             f"{sorted(ref - got)}")
    say("train", f"metrics.jsonl has r5_flagship's {len(ref)} keys")
    check_round_trip("train", runner, os.path.join(
        logdir, "checkpoints", "train_state_last.pkl"))
    check_poses_and_video(runner, logdir)
    check_export(runner, logdir)

    # the terrain variant alone on the flagship's own state and window
    grid = env.collision_grid
    state = runner.env_state
    layout = CP.check_supported(env.model, cfg.sim, terrain=grid)
    params, imp, win = env.physics_inputs(state)
    gt = CP.geom_terrain_at(env.model, cfg.sim, layout, state.sim, grid, win)
    x = CP.pack_inputs(env.model, state.sim, state.torques, params, imp,
                       grid, gt)
    y = torch.empty((CP.out_channels(env.model), env.num_envs), device=dev)
    cst = CP.KERNEL.table(env.model, cfg.sim, layout, dev)
    k_ms = time_ms(
        lambda: CP.KERNEL.launch_packed(x, y, cst, layout, True, True), 50)
    last = runs[-1]
    step_ms = last["rollout_s"] / runner.args.num_steps_per_env * 1e3
    say("train", f"steady iteration: {last['env_steps_per_s']:.0f} "
        f"env-steps/s, rollout {last['rollout_s']:.3f}s "
        f"({step_ms:.1f} ms/env step), update {last['update_s']:.3f}s; "
        f"kernel {k_ms:.4f} ms/launch on the flagship state "
        f"({k_ms * cfg.control.decimation / step_ms * 100:.1f}% of an env "
        f"step); peak memory {peak / 2**20:.1f} MiB | {card_line()}")
    # the terrain launches counted over the run, before the timing launches
    return dict(launches=seen[-1][1][VARIANTS.index("terrain")],
                kernel_ms_flagship=k_ms, peak_bytes=peak, iterations=runs)


HLP_RECIPE = ["--ll-run", os.path.join("runs", "r4_flagship_4000"),
              "--num-envs", "1024", "--min-std", "0.2", "--entropy-coef",
              "0.0", "--zero-reward-on-reset", "0", "--progress-scale", "1.0",
              "--max-lr", "1e-3", "--dead-zone", "0", "--goal-radius", "0.5"]
HLP_RESUME = os.path.join("runs", "r5_hlp7", "checkpoints",
                          "train_state_last.pkl")


def script(name):
    """scripts/<name> as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_keys(path):
    """The metric keys of a metrics.jsonl."""
    with open(path) as f:
        return set().union(*(json.loads(x) for x in f)) - {"_timestamp"}


def run_dir(name):
    """A fresh directory for a run's logs inside the checkout's build/."""
    import shutil
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke", name)
    shutil.rmtree(d, ignore_errors=True)
    return d


def check_finite(phase, runner):
    import torch
    m = runner.last_metrics
    for k in ("mean_value_loss", "mean_surrogate_loss",
              "mean_adaptation_loss", "kl", "lr", "mean_reward"):
        if not (k in m and torch.isfinite(torch.tensor(m[k]))):
            raise AssertionError(f"{phase}: {k} = {m.get(k)} is not finite")
    if not all(torch.isfinite(p).all() for p in runner.ac.parameters()):
        raise AssertionError(f"{phase}: non-finite parameters")
    ll = getattr(runner.env_state, "ll", runner.env_state)  # HLP or not
    for name, v in ll.sim._asdict().items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"{phase}: sim state {name} is not finite")
    if not torch.isfinite(runner.env_state.obs).all():
        raise AssertionError(f"{phase}: observations are not finite")


def check_round_trip(phase, runner, path):
    """The train state written at ``path`` reads back (through the loader
    of a resume) to the runner's params, Adam states, LR and env state,
    tensor for tensor."""
    import torch
    from rapid_locomotion_rl_tpu_torch import convert
    from rapid_locomotion_rl_tpu_torch.models.networks import ActorCritic
    from rapid_locomotion_rl_tpu_torch.utils.checkpoint import load_pytree
    payload = load_pytree(path)
    ac = ActorCritic(runner.env.num_obs, runner.env.num_privileged_obs,
                     runner.env.num_obs_history, runner.env.num_actions,
                     runner.ac_args).to(runner.device)
    ps = convert.ppo_state_from_jax(payload["ppo_state"], ac,
                                    runner.ppo_args)
    pairs = [(k, v, ac.state_dict()[k])
             for k, v in runner.ac.state_dict().items()]
    names = {id(p): k for k, p in runner.ac.named_parameters()}
    theirs = dict(ac.named_parameters())
    # the policy's Adam and, with the latent branch, the adaptation module's
    for opt, opt_back in ((runner.ppo_state.opt, ps.opt),
                          (runner.ppo_state.adapt_opt, ps.adapt_opt)):
        if (opt is None) != (opt_back is None):
            raise AssertionError(f"{phase}: an optimizer is missing")
        for p in [] if opt is None else opt.param_groups[0]["params"]:
            k = names[id(p)]
            mine, back = opt.state[p], opt_back.state[theirs[k]]
            pairs += [(f"{k} {f}", mine[f], back[f])
                      for f in ("step", "exp_avg", "exp_avg_sq")]
    env2 = convert.state_from_jax(payload["env_state"], runner.device)

    def leaves(prefix, x):
        if isinstance(x, dict):
            return [t for k in sorted(x) for t in leaves(f"{prefix}.{k}",
                                                         x[k])]
        if isinstance(x, tuple):
            return [t for f, v in zip(x._fields, x)
                    for t in leaves(f"{prefix}.{f}", v)]
        return [(prefix, x)]
    mine, back = leaves("env", runner.env_state), leaves("env", env2)
    pairs += [(k, a, b) for (k, a), (_, b) in zip(mine, back)]
    bad = [k for k, a, b in pairs if not torch.equal(a.cpu(), b.cpu())]
    if bad or len(mine) != len(back) or ps.lr != runner.ppo_state.lr:
        raise AssertionError(f"{phase}: checkpoint read back differs: "
                             f"{bad[:8]}, lr {ps.lr} vs "
                             f"{runner.ppo_state.lr}")
    say(phase, f"checkpoint {os.path.basename(path)} read back equal: "
        f"{len(pairs) - len(mine)} params and Adam tensors, lr "
        f"{ps.lr:.6g}, {len(mine)} env-state tensors")


def phase_hlp(dev):
    """scripts/high_level_play_cuda.py's main path on the card: the frozen
    runs/r4_flagship_4000 student under the HLP env at 1024 envs (trimesh,
    the corridor off), r5_hlp7's recipe, resumed from its train state
    (params, both Adam states, LR, env state), 2 iterations of 200 steps
    through the Runner into a scratch logdir."""
    import json
    import numpy as np
    import torch
    mod = script("high_level_play_cuda.py")
    logdir = run_dir("hlp")
    argv = HLP_RECIPE + ["--resume", HLP_RESUME, "--iterations",
                         str(ITERATIONS), "--logdir", logdir,
                         "--device", str(dev)]
    say("hlp", "high_level_play_cuda.py " + " ".join(argv))
    t = time.time()
    runner = mod.build_runner(mod.parse_args(argv))
    torch.cuda.synchronize()
    start = runner.current_learning_iteration
    say("hlp", f"low level, HLP env ({runner.env.num_envs} envs: "
        f"{runner.env.num_train_envs} train, {runner.env.num_eval_envs} "
        f"eval) and the resumed state (iteration {start}, lr "
        f"{runner.ppo_state.lr:.6g}) loaded in {time.time() - t:.2f}s")
    if start != 5200:
        raise AssertionError(f"resumed at iteration {start}, not 5200")

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    goals = []
    log_iteration = runner._log_iteration

    def logged(it, metrics):
        log_iteration(it, metrics)
        goals.append(runner.last_metrics["goal_reached_count"])
    runner._log_iteration = logged
    runner.learn(ITERATIONS, eval_freq=200)
    torch.cuda.synchronize()
    terr = read_counts()[1]
    peak = torch.cuda.max_memory_allocated()
    steps = runner.args.num_steps_per_env
    check_counts("hlp", read_counts(), terrain=ITERATIONS * steps
                 * runner.env.ll_env.cfg.control.decimation)
    check_finite("hlp", runner)
    if not float(np.float32(1e-5)) <= runner.ppo_state.lr <= 1e-3:
        raise AssertionError(f"lr {runner.ppo_state.lr} out of [1e-5, 1e-3]")
    for i, tm in enumerate(runner.timings):
        total = tm["rollout_s"] + tm["update_s"]
        say("hlp", f"iteration {start + i}: rollout {tm['rollout_s']:.3f}s "
            f"({tm['rollout_s'] / steps * 1e3:.1f} ms/env step), update "
            f"{tm['update_s']:.3f}s ({tm['update_s'] / total:.1%}), "
            f"{steps * runner.env.num_envs / total:.0f} env-steps/s; goals "
            f"reached {goals[i]:.0f}")
    m = runner.last_metrics
    say("hlp", f"last iteration: value loss {m['mean_value_loss']:.4g}, "
        f"surrogate {m['mean_surrogate_loss']:.4g}, adaptation "
        f"{m['mean_adaptation_loss']:.4g}, kl {m['kl']:.4g}, lr "
        f"{runner.ppo_state.lr:.4g}, mean reward {m['mean_reward']:.5f}; "
        f"{terr} terrain-variant launches; peak memory "
        f"{peak / 2**20:.1f} MiB | {card_line()}")
    if sum(goals) < 1:
        raise AssertionError(f"no goal reached in {ITERATIONS} iterations")

    got = metric_keys(os.path.join(logdir, "metrics.jsonl"))
    ref = metric_keys(os.path.join("runs", "r5_hlp7", "metrics.jsonl"))
    if got != ref:
        raise AssertionError(f"metric keys differ from r5_hlp7's: extra "
                             f"{sorted(got - ref)}, missing "
                             f"{sorted(ref - got)}")
    say("hlp", f"metrics.jsonl has r5_hlp7's {len(ref)} keys")
    check_round_trip("hlp", runner, os.path.join(
        logdir, "checkpoints", "train_state_last.pkl"))
    return dict(launches=terr, peak_bytes=peak, timings=runner.timings,
                goals=goals)


def have_pillow():
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def check_gif(phase, path, frame):
    """With Pillow: the GIF at ``path`` exists and holds at least 2
    frames. Without it: ``frame()`` (render_frame_rgb's array of a pose)
    has the camera's shape, the robot's orange pixels and the terrain's
    brown ones."""
    import numpy as np
    if have_pillow():
        from PIL import Image
        if not (path and os.path.exists(path)):
            raise AssertionError(f"{phase}: no GIF at {path}")
        with Image.open(path) as im:
            n = im.n_frames
        if n < 2:
            raise AssertionError(f"{phase}: {path} holds {n} frame(s)")
        say(phase, f"{path}: {n} frames, {os.path.getsize(path)} bytes")
        return
    say(phase, "no GIF written: Pillow is not installed; holding "
        "render_frame_rgb's frame instead")
    img = frame().astype(np.int32)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    sky = (r == 188) & (g == 209) & (b == 229)
    robot = (r > 140) & (g > 60) & (b < 120) & (g < 0.7 * r)
    ground = ~sky & (r > b) & (g > b) & (g >= 0.75 * r)
    say(phase, f"frame {img.shape}: {int(robot.sum())} robot, "
        f"{int(ground.sum())} terrain, {int(sky.sum())} sky pixels")
    if img.shape != (240, 320, 3) or robot.sum() < 30 or ground.sum() < 300:
        raise AssertionError(f"{phase}: the frame lacks the robot or the "
                             f"terrain")


def check_poses_and_video(runner, logdir):
    """The rollout's env-0 pose log reached the Runner's ring buffer, one
    [24, ...] entry an iteration, its last pose env 0's final one; the
    video of iteration 4000 (on the 400 cadence) was written."""
    import numpy as np
    from rapid_locomotion_rl_tpu_torch.utils.raster import render_frame_rgb
    from rapid_locomotion_rl_tpu_torch.utils.render import env_terrain
    buf = runner._pose_buffer
    T = runner.args.num_steps_per_env
    nv = runner.env.num_dof
    shapes = [tuple(a.shape) for a in buf[-1]]
    if len(buf) != ITERATIONS or shapes != [(T, 3), (T, 4), (T, nv),
                                            (T, 3)]:
        raise AssertionError(f"train: pose buffer of {len(buf)} entries, "
                             f"shapes {shapes}")
    last = runner.env_state.sim.base_pos[0].cpu().numpy()
    if not (np.array_equal(buf[-1][0][-1], last)
            and all(np.isfinite(a).all() for e in buf for a in e)):
        raise AssertionError("train: the pose log is not env 0's")
    say("train", f"pose buffer: {len(buf)} rollouts of env 0's poses "
        f"{shapes}")
    pos, quat, q, _ = buf[-1]
    check_gif("train", os.path.join(logdir, "videos", "04000.gif"),
              lambda: render_frame_rgb(runner.env.model, pos[-1], quat[-1],
                                       q[-1], terrain=env_terrain(
                                           runner.env)))


def check_export(runner, logdir):
    """student_policy_latest.pt2 reloads and gives the policy's
    act_student output on the run's observations, one env a call (the
    program's shapes are (1, num_obs) and (1, num_obs_history))."""
    import torch
    path = os.path.join(logdir, "checkpoints", "student_policy_latest.pt2")
    program = torch.export.load(path).module()
    s = runner.env_state
    with torch.no_grad():
        for i in range(8):
            o, h = s.obs[i:i + 1], s.obs_history[i:i + 1]
            got, want = program(o, h), runner.ac.act_student(o, h)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"train: the .pt2 policy differs on env {i} by "
                    f"{(got - want).abs().max().item():.3g}")
    say("train", f"{os.path.basename(path)} reloads: act_student equal on "
        f"8 envs' observations ({os.path.getsize(path)} bytes)")


def phys_inputs(env, state):
    """The physics call's inputs at an env state: its sim state, last
    torques, DR parameters and implicit-PD impedance."""
    params, imp, _ = env.physics_inputs(state)
    return state.sim, state.torques, params, imp


def hold_on_env(phase, env, state):
    """The terrain variant against its plain version on the state an entry
    ended on, by hold_kernel's rules, at the entry's width: the state
    lifted 1.5 m with zero torques (flight, strict) and the state itself
    with its last torques (grounded, in bulk), looked up through the env's
    own window; two launches bitwise equal; times."""
    import torch
    sim, tau, params, imp = phys_inputs(env, state)
    grid = env.collision_grid

    def make_inputs(seed, airborne):
        if not airborne:
            return sim, tau, params, imp
        up = sim.base_pos + torch.tensor([0.0, 0.0, 1.5], device=tau.device)
        return sim._replace(base_pos=up), torch.zeros_like(tau), params, imp

    k = hold_kernel(
        phase, env.model, env.cfg.sim, make_inputs, env.num_envs,
        terrain=grid, window=None if grid is None else (
            lambda s: env._window(grid, s.base_pos[:, 0], s.base_pos[:, 1])),
        sloped=False)
    k["n"] = env.num_envs
    return k


def finite_state(phase, state):
    import torch
    for name, v in state.sim._asdict().items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"{phase}: sim state {name} is not finite")


PLAY_STEPS = 150
TEST_STEPS = 100
EVAL_STEPS = 50
HLP_PLAY_STEPS = 50
LL_RUN = os.path.join("runs", "r4_flagship_4000")


def phase_play(dev):
    """scripts/play_cuda.py's play() on runs/r4_flagship_4000: 1 env, 150
    steps at vx 1.0, a GIF into a scratch directory."""
    import numpy as np
    import torch
    from rapid_locomotion_rl_tpu_torch.utils.raster import render_frame_rgb
    from rapid_locomotion_rl_tpu_torch.utils.render import env_terrain
    mod = script("play_cuda.py")
    gif = os.path.join(run_dir("play"), "play.gif")
    zero_counts()
    t = time.time()
    r = mod.play(LL_RUN, PLAY_STEPS, (1.0, 0.0, 0.0), gif=gif,
                 device=str(dev), gif_stride=10)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = read_counts()
    env, state = r["env"], r["state"]
    check_counts("play", counts, terrain=PLAY_STEPS
                 * env.cfg.control.decimation)
    finite_state("play", state)
    h = r["height"]
    if env.num_envs != 1 or r["done"].any() or not (
            (0.15 < h) & (h < 0.5)).all():
        raise AssertionError(f"play: {env.num_envs} envs, resets "
                             f"{int(r['done'].sum())}, base height "
                             f"[{h.min():.3f}, {h.max():.3f}] m")
    say("play", f"{PLAY_STEPS} steps x 1 env: {counts[1]} terrain-variant "
        f"launches, no reset, base height [{h.min():.3f}, {h.max():.3f}] m; "
        f"mean vx over the last 100 steps {np.mean(r['vx'][-100:]):.3f} m/s "
        f"(command 1.0); {wall:.2f}s with the GIF "
        f"({wall / PLAY_STEPS * 1e3:.1f} ms a step) | {card_line()}")
    s = state.sim
    check_gif("play", r["gif"], lambda: render_frame_rgb(
        env.model, s.base_pos[0].cpu().numpy(), s.base_quat[0].cpu().numpy(),
        s.q[0].cpu().numpy(), terrain=env_terrain(env)))
    k = hold_on_env("play", env, state)
    k.update(launches=counts[1], s_per_step=wall / PLAY_STEPS)
    return k


def phase_test(dev):
    """scripts/test_cuda.py's run_env(3, 100): zero actions, finite
    rewards."""
    import torch
    mod = script("test_cuda.py")
    zero_counts()
    t = time.time()
    env, state, rows = mod.run_env(3, TEST_STEPS, device=str(dev))
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = read_counts()
    check_counts("test", counts, terrain=TEST_STEPS
                 * env.cfg.control.decimation)
    finite_state("test", state)
    say("test", f"{TEST_STEPS} steps x 3 envs: {counts[1]} terrain-variant "
        f"launches; (step, mean reward, mean height) {rows}; {wall:.2f}s "
        f"({wall / TEST_STEPS * 1e3:.1f} ms a step)")
    k = hold_on_env("test", env, state)
    k.update(launches=counts[1], s_per_step=wall / TEST_STEPS)
    return k



def phase_eval(dev):
    """scripts/eval_sweep_cuda.py's evaluate() on runs/r4_flagship_4000,
    preset static_medium, 256 envs, 50 steps."""
    import numpy as np
    import torch
    from rapid_locomotion_rl_tpu_torch.learn import metrics as M
    from rapid_locomotion_rl_tpu_torch.learn.dr_eval import DR_SETTINGS
    mod = script("eval_sweep_cuda.py")
    seen = {}
    probe = M.METRICS_FNS["base_height"]

    def watched(env, state, ac, params):
        seen.update(env=env, state=state)
        return probe(env, state, ac, params)
    M.METRICS_FNS["base_height"] = watched
    zero_counts()
    t = time.time()
    try:
        out = mod.evaluate(LL_RUN, "static_medium",
                           DR_SETTINGS["static_medium"], 256, EVAL_STEPS,
                           device=str(dev))
    finally:
        M.METRICS_FNS["base_height"] = probe
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = read_counts()
    env = seen["env"]
    check_counts("eval", counts, terrain=EVAL_STEPS
                 * env.cfg.control.decimation)
    for name in M.METRICS_FNS:
        keys = [k for k in out if k == name or k.startswith(name + "/")]
        if not keys or not all(np.isfinite(out[k]).all() for k in keys):
            raise AssertionError(f"eval: {name} missing or not finite")
    if not out["done_rate"] < 0.05:
        raise AssertionError(f"eval: done_rate {out['done_rate']}")
    say("eval", f"static_medium, {EVAL_STEPS} steps x 256 envs: "
        f"{counts[1]} terrain-variant launches; done_rate "
        f"{out['done_rate']:.5f}, lin_vel_rmsd {out['lin_vel_rmsd']:.4f}, "
        f"ang_vel_rmsd {out['ang_vel_rmsd']:.4f}, cost_of_transport "
        f"{out['cost_of_transport']:.4f}, adaptation_loss "
        f"{out['adaptation_loss']:.4f}, base_height "
        f"{out['base_height']:.4f}, contact_rate {out['contact_rate']:.4f};"
        f" {len(out)} keys finite; {wall:.2f}s "
        f"({wall / EVAL_STEPS * 1e3:.1f} ms a step)")
    k = hold_on_env("eval", env, seen["state"])
    k.update(launches=counts[1], s_per_step=wall / EVAL_STEPS)
    return k


def phase_hlp_play(dev):
    """scripts/hlp_play_cuda.py on runs/r5_hlp7: 16 envs, 50 steps, a
    GIF."""
    import torch
    from rapid_locomotion_rl_tpu_torch.utils.raster import render_frame_rgb
    from rapid_locomotion_rl_tpu_torch.utils.render import env_terrain
    mod = script("hlp_play_cuda.py")
    gif = os.path.join(run_dir("hlp_play"), "nav.gif")
    argv = ["--hlp-run", os.path.join("runs", "r5_hlp7"), "--num-envs",
            "16", "--steps", str(HLP_PLAY_STEPS), "--gif", gif, "--device",
            str(dev)]
    say("hlp-play", "hlp_play_cuda.py " + " ".join(argv))
    zero_counts()
    t = time.time()
    r = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = read_counts()
    ll_env, ll = r["env"].ll_env, r["state"].ll
    check_counts("hlp-play", counts, terrain=HLP_PLAY_STEPS
                 * ll_env.cfg.control.decimation)
    finite_state("hlp-play", ll)
    if not torch.isfinite(r["state"].obs).all():
        raise AssertionError("hlp-play: observations are not finite")
    say("hlp-play", f"{HLP_PLAY_STEPS} steps x 16 envs: {counts[1]} "
        f"terrain-variant "
        f"launches; goals {r['goals']}, timeouts {r['timeouts']}, falls "
        f"{r['falls']}, episodes {r['episodes']}; closest approach "
        f"{r['min_dist'].min():.3f} m (env {r['best_env']}); {wall:.2f}s "
        f"with the GIF ({wall / HLP_PLAY_STEPS * 1e3:.1f} ms a step)")
    s = ll.sim
    b = r["best_env"]
    check_gif("hlp-play", r["gif"], lambda: render_frame_rgb(
        ll_env.model, s.base_pos[b].cpu().numpy(),
        s.base_quat[b].cpu().numpy(), s.q[b].cpu().numpy(),
        terrain=env_terrain(ll_env)))
    k = hold_on_env("hlp-play", ll_env, ll)
    k.update(launches=counts[1], s_per_step=wall / HLP_PLAY_STEPS)
    return k


def phase_hlp_world(dev):
    """The same entry with the corridor on (cfg.world, --world) from a
    fresh state: one iteration, every physics call through the terrain +
    world variant; some env pressed against a wall. Then the kernel
    against its plain version on the low-level state at the iteration's
    end (its last torques, DR parameters, terrain window and origins):
    every state field and the report entries that the walls
    change in bulk (>= 99% within atol + 1e-3 |ref|, as for grounded
    states), geom positions at 1e-5."""
    import torch
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    from rapid_locomotion_rl_tpu_torch.ops.soa_physics import physics_step_soa
    mod = script("high_level_play_cuda.py")
    argv = HLP_RECIPE + ["--world", "--iterations", "1", "--logdir",
                         run_dir("hlp_world"), "--device", str(dev)]
    say("hlp-world", "high_level_play_cuda.py " + " ".join(argv))
    runner = mod.build_runner(mod.parse_args(argv))
    torch.cuda.synchronize()
    zero_counts()
    runner.learn(1, eval_freq=200)
    torch.cuda.synchronize()
    wld = read_counts()[2]
    ll_env = runner.env.ll_env
    check_counts("hlp-world", read_counts(), world=runner.args
                 .num_steps_per_env * ll_env.cfg.control.decimation)
    check_finite("hlp-world", runner)
    tm = runner.timings[0]
    total = tm["rollout_s"] + tm["update_s"]

    # the walls' share of the contact report at the final state: one call
    # with the corridor and one without (not counted)
    ll = runner.env_state.ll
    pp, imp, win = ll_env.physics_inputs(ll)
    grid = ll_env.collision_grid
    kw = dict(terrain=grid, implicit_damp=imp, terrain_window=win)
    walled = CP.physics_step_cuda(
        ll_env.model, ll_env.cfg.sim, ll.sim, ll.torques, pp,
        world_boxes=ll_env.world_boxes, env_origin=ll.env_origins,
        world_friction=ll_env.cfg.terrain.static_friction, **kw)
    free = CP.physics_step_cuda(ll_env.model, ll_env.cfg.sim, ll.sim,
                                ll.torques, pp, **kw)
    torch.cuda.synchronize()
    pressed = (walled.contact_report != free.contact_report).any(-1).any(-1)
    plain = physics_step_soa(
        ll_env.model, ll_env.cfg.sim, ll.sim, ll.torques, pp,
        world_boxes=ll_env.world_boxes, env_origin=ll.env_origins,
        world_friction=ll_env.cfg.terrain.static_friction, **kw)
    plain_free = physics_step_soa(ll_env.model, ll_env.cfg.sim, ll.sim,
                                  ll.torques, pp, **kw)
    torch.cuda.synchronize()
    for name in plain.state._fields:
        atol = 1e-2 if name in ("qd", "base_lin_vel", "base_ang_vel") else 1e-3
        mostly_close("hlp-world", name, getattr(walled.state, name),
                     getattr(plain.state, name), atol, label="HLP state")
    by_walls = plain.contact_report != plain_free.contact_report
    if int(by_walls.sum()) == 0:
        raise AssertionError("HLP state: no wall force in the plain version")
    mostly_close("hlp-world", "wall report entries", walled.contact_report,
                 plain.contact_report, 0.5, where=by_walls,
                 label="HLP state")
    torch.testing.assert_close(walled.geom_pos, plain.geom_pos, rtol=1e-5,
                               atol=1e-5)
    say("hlp-world", f"{wld} world-variant launches; rollout "
        f"{tm['rollout_s']:.3f}s, update {tm['update_s']:.3f}s, "
        f"{runner.args.num_steps_per_env * runner.env.num_envs / total:.0f} "
        f"env-steps/s; {int(pressed.sum())} envs pressed against a wall at "
        f"the end; kl {runner.last_metrics['kl']:.4g}, lr "
        f"{runner.ppo_state.lr:.4g} | {card_line()}")
    if int(pressed.sum()) == 0:
        raise AssertionError("no env touches a wall")
    return dict(launches=wld, timings=tm)


# ---------------------------------------------------------------------------
# the general (AoS) step, MJCF, height sensing and the VecEnv
# ---------------------------------------------------------------------------
N_AOS = 256
AOS_ITERATIONS = 1


def phase_start():
    """Zeroed peak memory and the start time of a phase."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return time.time()


def phase_end(phase, t, launches):
    """The phase's seconds, K1 launches and peak memory, on one line."""
    import torch
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    say(phase, f"phase {time.time() - t:.2f}s, K1 launches {launches}, "
        f"peak memory {peak / 2**20:.1f} MiB | {card_line()}")
    return peak


def cuda_kernels_per_call(fn):
    """CUDA kernels one call of ``fn`` runs, counted by torch.profiler's
    device events, and the aten operations it dispatches; the kernel count
    is None when the profiler records no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    fn()
    torch.cuda.synchronize()
    with Count():
        fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    return (len(dev_events) or None), Count.n


def to_cpu(x):
    """A tensor, or a tuple or named tuple of them, on the CPU."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.cpu()
    items = [to_cpu(v) for v in x]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def hold_states(phase, out_a, out_b, strict, label, frac=0.99,
                report=True):
    """Two StepOutputs: strictly (rtol/atol 2e-5 on the state, 1e-5 on
    geom positions, no contact force) or in bulk by mostly_close's rule
    with its floor ``frac`` (the contact reports too, unless ``report`` is
    off); returns the strict case's max |err|."""
    import torch
    err = 0.0
    for name in out_b.state._fields:
        a, b = getattr(out_a.state, name), getattr(out_b.state, name)
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label} {name}: non-finite output")
        if strict:
            torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5,
                                       msg=lambda m: f"{label} {name}: {m}")
            err = max(err, (a - b).abs().max().item())
        else:
            atol = (1e-2 if name in ("qd", "base_lin_vel", "base_ang_vel")
                    else 1e-3)
            mostly_close(phase, name, a, b, atol, label=label, frac=frac)
    torch.testing.assert_close(out_a.geom_pos, out_b.geom_pos, rtol=1e-5,
                               atol=1e-5)
    if strict:
        if out_a.contact_report.abs().max().item() != 0.0:
            raise AssertionError(f"{label}: contact force in the air")
    else:
        if out_b.contact_report.abs().max().item() < 1.0:
            raise AssertionError(f"{label}: no contact")
    if not strict and report:
        mostly_close(phase, "contact_report", out_a.contact_report,
                     out_b.contact_report, 0.5,
                     where=out_b.contact_report != 0, label=label, frac=frac)
    return err


def phase_aos(dev, tc, grid):
    """The general (AoS) step, ops/physics.py: plain PyTorch, not a
    kernel. On the card against the same code on the CPU at 256 Mini
    Cheetah envs over the mix (flight strictly, grounded in bulk by the
    99% rule), for both contact models; at 4000 envs against K1's terrain
    variant (and the legacy one) in bulk by the repo's AoS-vs-SoA floor of
    90% (tests/test_contact_features.py: the two orders of the same
    algebra part on contact-branch boundaries more often than two builds
    of one order), on the state only (the AoS step reports the last
    substep's contact forces, K1 the first's); ms, aten operations and
    CUDA kernels per call."""
    import copy
    import numpy as np
    import torch
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    from rapid_locomotion_rl_tpu_torch.ops.contact import (
        blocked_window, terrain_height_bilinear)
    from rapid_locomotion_rl_tpu_torch.ops.physics import physics_step
    t0 = phase_start()
    zero_counts()
    cfg, model = robot(config_mini_cheetah)
    grid_cpu = grid._replace(height=grid.height.cpu())

    def inputs(n, seed, airborne):
        rng = np.random.default_rng(SEED + 7)
        xy = torch.tensor(np.stack([
            rng.uniform(0.5, tc.num_rows * tc.terrain_length - 0.5, n),
            rng.uniform(0.5, tc.num_cols * tc.terrain_width - 0.5, n)], -1),
            dtype=torch.float32, device=dev)
        under = terrain_height_bilinear(grid, xy[:, 0], xy[:, 1])
        state, tau, params, imp = random_inputs(model, n, seed, airborne,
                                                dev)
        pos = torch.cat([xy, state.base_pos[:, 2:] + under[:, None]], -1)
        return state._replace(base_pos=pos), tau, params, imp

    result = {}
    for cm in ("apparent", "legacy"):
        sim = copy.deepcopy(cfg.sim)
        sim.contact_model = cm
        for airborne in (True, False):
            state, tau, params, imp = inputs(N_AOS, 3 if airborne else 0,
                                             airborne)
            out_c = physics_step(model, sim, state, tau, params, grid,
                                 implicit_damp=imp)
            out_h = physics_step(model, sim, *to_cpu((state, tau, params)),
                                 grid_cpu, implicit_damp=imp.cpu())
            label = f"{cm} {'flight' if airborne else 'grounded'}"
            err = hold_states("aos", to_cpu(out_c), out_h, airborne,
                              f"card vs CPU {label}")
            if airborne:
                result[f"{cm}_card_cpu_err"] = err
                say("aos", f"card vs CPU, {label} N={N_AOS}: state max "
                    f"|err| {err:.3g} (rtol/atol 2e-5), geom_pos ok (1e-5)")
        # against K1 at the flagship's width, in bulk
        state, tau, params, imp = inputs(N_MC, 0, False)
        win = blocked_window(grid, state.base_pos[:, 0], state.base_pos[:, 1])
        out_a = physics_step(model, sim, state, tau, params, grid,
                             implicit_damp=imp)
        out_k = CP.physics_step_cuda(model, sim, state, tau, params,
                                     terrain=grid, implicit_damp=imp,
                                     terrain_window=win)
        # the report is not compared: the AoS step reports the last
        # substep's contact forces, K1 (as the JAX SoA step) the first's
        hold_states("aos", out_a, out_k, False, f"AoS vs K1 {cm} N={N_MC}",
                    frac=0.9, report=False)
        ms = time_ms(lambda: physics_step(model, sim, state, tau, params,
                                          grid, implicit_damp=imp), 3)
        kernels, ops = cuda_kernels_per_call(
            lambda: physics_step(model, sim, state, tau, params, grid,
                                 implicit_damp=imp))
        result[cm] = dict(ms=ms, kernels=kernels, ops=ops)
        say("aos", f"{cm}: {ms:.1f} ms/call at N={N_MC} ({sim.num_substeps} "
            f"substeps), {ops} aten operations and "
            + (f"{kernels} CUDA kernels" if kernels else
               "CUDA kernels not measured (the profiler saw none)")
            + " a call")
    # K1 ran only to be compared with
    result["peak_bytes"] = phase_end(
        "aos", t0, f"{sum(read_counts())} (the comparisons)")
    return result


def phase_aos_train(dev):
    """scripts/train_cuda.py's main with --physics-impl aos on the flagship
    (config_mini_cheetah, 4000 envs, trimesh), resumed from
    runs/r5_flagship, one Runner iteration into a scratch logdir: no K1
    launch, finite losses and params, KL and LR in range, the robots up."""
    import numpy as np
    import torch
    mod = script("train_cuda.py")
    logdir = run_dir("aos_train")
    argv = ["--resume", MC_STATE, "--iterations", str(AOS_ITERATIONS),
            "--logdir", logdir, "--device", str(dev), "--physics-impl",
            "aos"]
    say("aos-train", "train_cuda.py " + " ".join(argv))
    t0 = phase_start()
    zero_counts()
    runner = mod.main(argv)
    torch.cuda.synchronize()
    env = runner.env
    if env.physics_impl != "aos" or env._window is not None:
        raise AssertionError("aos-train: the env is not on the AoS step")
    check_counts("aos-train", read_counts())
    if len(runner.timings) != AOS_ITERATIONS:
        raise AssertionError(f"{len(runner.timings)} iterations ran")
    m = runner.last_metrics
    for k in ("mean_value_loss", "mean_surrogate_loss",
              "mean_adaptation_loss", "kl", "lr", "mean_reward"):
        if not np.isfinite(m[k]):
            raise AssertionError(f"aos-train: {k} = {m[k]}")
    if not 0.003 <= m["kl"] <= 0.1:
        raise AssertionError(f"aos-train: kl {m['kl']} out of [0.003, 0.1]")
    # the LR is a float32: its floor 1e-5 is 9.99999975e-06
    if not float(np.float32(1e-5)) <= m["lr"] <= 1e-2:
        raise AssertionError(f"aos-train: lr {m['lr']} out of [1e-5, 1e-2]")
    if not all(torch.isfinite(p).all() for p in runner.ac.parameters()):
        raise AssertionError("aos-train: non-finite parameters")
    finite_state("aos-train", runner.env_state)
    z = runner.env_state.sim.base_pos[:, 2].mean().item()
    if not 0.15 < z < 0.5:
        raise AssertionError(f"aos-train: mean base z {z:.3f}")
    tm = runner.timings[-1]
    total = tm["rollout_s"] + tm["update_s"]
    steps = runner.args.num_steps_per_env
    say("aos-train", f"iteration {runner.current_learning_iteration - 1}: "
        f"0 K1 launches; rollout {tm['rollout_s']:.3f}s "
        f"({tm['rollout_s'] / steps * 1e3:.1f} ms/env step), update "
        f"{tm['update_s']:.3f}s ({tm['update_s'] / total:.1%}), "
        f"{steps * env.num_envs / total:.0f} env-steps/s; value loss "
        f"{m['mean_value_loss']:.4g}, surrogate "
        f"{m['mean_surrogate_loss']:.4g}, kl {m['kl']:.4g}, lr {m['lr']:.4g}, mean reward "
        f"{m['mean_reward']:.5f}, base z {z:.3f} m")
    peak = phase_end("aos-train", t0, 0)
    return dict(timings=tm, env_steps_per_s=steps * env.num_envs / total,
                peak_bytes=peak)


MJCF_ASSET = "{ROOT}/resources/robots/go1/xml/go1.xml"


def go1_xml_env(dev, impl="auto"):
    from rapid_locomotion_rl_tpu_torch.config import config_go1
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
    cfg = config_go1()
    cfg.asset.file = MJCF_ASSET
    cfg.sim.physics_impl = impl
    return LeggedRobotEnv(cfg, device=dev)


def horizon(env, ac, state, sampler):
    """One PPO horizon of the policy; the trajectory finite."""
    import torch
    from rapid_locomotion_rl_tpu_torch.learn.ppo import PPOArgs, rollout
    state, traj, info = rollout(env, ac, PPOArgs(), state, sampler, HORIZON)
    torch.cuda.synchronize()
    for k, v in list(traj._asdict().items()) + list(info.items()) + \
            list(state.sim._asdict().items()):
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise AssertionError(f"{k} is not finite")
    return state, traj


def phase_mjcf(dev):
    """config_go1 with the MJCF asset (resources/robots/go1/xml/go1.xml),
    4096 envs on the plane, under the runs/r4_go1 policy for one horizon:
    all 96 calls through K1's plane variant with the MJCF constant table;
    the variant held to its plain version on the end state; then the same
    env on the AoS step for a horizon."""
    import torch
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    t0 = phase_start()
    env = go1_xml_env(dev)
    m = env.model
    ac, _ = load_run(env, WEIGHTS, dev)
    sampler = Sampler(SEED, dev)
    state = env.initial_state(sampler)
    say("mjcf", f"MJCF Go1 ({env.num_envs} envs, nv={m.nv}, ng={m.ng}, "
        f"nr={m.nr}, dof_velocity {float(m.dof_velocity.min()):.0f}-"
        f"{float(m.dof_velocity.max()):.0f}; feet {env.feet_indices}, "
        f"termination {env.termination_contact_indices}, penalised "
        f"{env.penalised_contact_indices}) and {WEIGHTS} loaded")
    zero_counts()
    t = time.time()
    state, traj = horizon(env, ac, state, sampler)
    wall = time.time() - t
    counts = read_counts()
    check_counts("mjcf", counts, plane=HORIZON * env.cfg.control.decimation)
    say("mjcf", f"{HORIZON} steps x {env.num_envs} envs: {counts[0]} "
        f"plane-variant launches; mean base z "
        f"{state.sim.base_pos[:, 2].mean().item():.3f} m, done rate "
        f"{traj.dones.float().mean().item():.4f}; {wall:.3f}s "
        f"({HORIZON * env.num_envs / wall:.0f} env-steps/s)")
    k = hold_on_env("mjcf", env, state)
    k["launches"] = counts[0]
    # the same env on the general step
    aos = go1_xml_env(dev, "aos")
    zero_counts()
    t = time.time()
    s2, traj2 = horizon(aos, ac, aos.initial_state(Sampler(SEED, dev)),
                        Sampler(SEED, dev))
    wall2 = time.time() - t
    check_counts("mjcf aos", read_counts())
    say("mjcf", f"AoS step: {HORIZON} steps x {aos.num_envs} envs, 0 K1 "
        f"launches, finite; mean base z "
        f"{s2.sim.base_pos[:, 2].mean().item():.3f} m; {wall2:.2f}s "
        f"({HORIZON * aos.num_envs / wall2:.0f} env-steps/s)")
    k["peak_bytes"] = phase_end("mjcf", t0, counts[0])
    return k


def phase_heights(dev, tc, grid):
    """config_mini_cheetah with terrain.measure_heights (187 points) at
    4000 envs on its trimesh under a fresh policy of that width, one
    horizon: 96 terrain-variant launches, finite; the env's measured
    heights on the card equal to the same rule on the CPU (a gather and a
    min: exact), on the env's state and on the mix's grid."""
    import numpy as np
    import torch
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.models.networks import (ACArgs,
                                                               ActorCritic)
    from rapid_locomotion_rl_tpu_torch.ops.contact import (
        _cells, terrain_height_min3_patch)
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    t0 = phase_start()
    cfg = config_mini_cheetah()
    cfg.terrain.measure_heights = True
    cfg.env.num_observations = 42 + 187
    env = LeggedRobotEnv(cfg, device=dev)
    torch.manual_seed(SEED)
    ac = ActorCritic(env.num_obs, env.num_privileged_obs,
                     env.num_obs_history, env.num_actions, ACArgs()).to(dev)
    sampler = Sampler(SEED, dev)
    state = env.initial_state(sampler)
    zero_counts()
    t = time.time()
    state, traj = horizon(env, ac, state, sampler)
    wall = time.time() - t
    counts = read_counts()
    check_counts("heights", counts,
                 terrain=HORIZON * cfg.control.decimation)
    mh = state.measured_heights
    if tuple(mh.shape) != (env.num_envs, 187) or not torch.isfinite(mh).all():
        raise AssertionError(f"heights: measured_heights {tuple(mh.shape)}")
    say("heights", f"{HORIZON} steps x {env.num_envs} envs, obs "
        f"{env.num_obs}: {counts[1]} terrain-variant launches, finite; "
        f"measured heights [{mh.min().item():.3f}, {mh.max().item():.3f}] "
        f"m (patch P={env._sense_patch_P}); {wall:.3f}s "
        f"({HORIZON * env.num_envs / wall:.0f} env-steps/s)")
    # the sensor on the card against the same rule on the CPU, at the same
    # points
    got = env._get_heights(state.sim)
    pts = env._height_points_world(state.sim)
    g = env.terrain_grid
    base = state.sim.base_pos
    ref = terrain_height_min3_patch(
        g._replace(height=g.height.cpu()), *to_cpu((
            base[:, 0], base[:, 1], pts[..., 0], pts[..., 1])),
        env._sense_patch_P)
    if not torch.equal(got.cpu(), ref):
        raise AssertionError(f"heights: card and CPU differ in "
                             f"{int((got.cpu() != ref).sum())} entries")
    # and on the mix's (non-flat) grid, bases spread over it
    rng = np.random.default_rng(SEED + 3)
    n = N_MC
    base = torch.tensor(np.stack([
        rng.uniform(1, tc.num_rows * tc.terrain_length - 1, n),
        rng.uniform(1, tc.num_cols * tc.terrain_width - 1, n)], -1),
        dtype=torch.float32, device=dev)
    pts = base[:, None, :] + torch.tensor(
        rng.normal(0, 0.5, (n, 187, 2)), dtype=torch.float32, device=dev)
    P = env._sense_patch_P
    hc = terrain_height_min3_patch(grid, base[:, 0], base[:, 1],
                                   pts[..., 0], pts[..., 1], P)
    hh = terrain_height_min3_patch(grid._replace(height=grid.height.cpu()),
                                   *to_cpu((base[:, 0], base[:, 1],
                                            pts[..., 0], pts[..., 1])), P)
    if not torch.equal(hc.cpu(), hh):
        raise AssertionError("heights: card and CPU differ on the mix")
    # the contact lookup's cells, from the same true quotient
    cells_c = _cells(grid, pts[..., 0], pts[..., 1], None)
    cells_h = _cells(grid._replace(height=grid.height.cpu()),
                     *to_cpu((pts[..., 0], pts[..., 1])), None)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(cells_c, cells_h)):
        raise AssertionError("heights: the lookup's cells and fractions "
                             "differ between card and CPU")
    say("heights", f"sensor on the card equal to the CPU's: the env's "
        f"{tuple(got.shape)} (flat grid) and {n} x 187 points on the mix "
        f"(heights [{hh.min().item():.3f}, {hh.max().item():.3f}] m); the "
        f"contact lookup's cells and fractions there equal too")
    peak = phase_end("heights", t0, counts[1])
    return dict(launches=counts[1], peak_bytes=peak, s=wall)


def phase_vecenv(dev):
    """envs/vec_env.py's VecEnvAdapter over Go1 (config_go1, 4096 envs,
    the plane): reset, ten steps, reset_idx, and the ten steps' obs split
    and padded at their dones and back, equal."""
    import torch
    from rapid_locomotion_rl_tpu_torch.config import config_go1
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.envs.vec_env import VecEnvAdapter
    from rapid_locomotion_rl_tpu_torch.learn.trajectories import (
        split_and_pad_trajectories, unpad_trajectories)
    t0 = phase_start()
    cfg = config_go1()
    vec = VecEnvAdapter(LeggedRobotEnv(cfg, device=dev), seed=SEED)
    zero_counts()
    vec.reset()
    gen = torch.Generator(dev)
    gen.manual_seed(SEED)
    obs, dones = [], []
    for _ in range(10):
        a = 0.3 * torch.randn((vec.num_envs, vec.num_actions), device=dev,
                              generator=gen)
        o, rew, done, info = vec.step(a)
        obs.append(o["obs"])
        dones.append(done)
        if not (torch.isfinite(o["obs"]).all() and torch.isfinite(rew).all()):
            raise AssertionError("vecenv: non-finite step")
    vec.reset_idx(torch.arange(0, vec.num_envs, 2, device=dev))
    if not (vec.episode_length_buf[::2] == 0).all():
        raise AssertionError("vecenv: reset_idx left an episode running")
    counts = read_counts()
    check_counts("vecenv", counts, plane=11 * cfg.control.decimation)
    x, d = torch.stack(obs), torch.stack(dones)
    padded, masks = split_and_pad_trajectories(x, d)
    back = unpad_trajectories(padded, d, vec.num_envs)
    if not torch.equal(back, x) or int(masks.sum()) != x.shape[0] * x.shape[1]:
        raise AssertionError("vecenv: the trajectories do not round-trip")
    say("vecenv", f"reset + 10 steps x {vec.num_envs} envs: {counts[0]} "
        f"plane-variant launches, {int(d.sum())} dones, "
        f"{int(masks[0].sum())} trajectories; split/pad of obs "
        f"{tuple(x.shape)} -> {tuple(padded.shape)} and back equal; "
        f"reset_idx of {vec.num_envs // 2} envs")
    peak = phase_end("vecenv", t0, counts[0])
    return dict(launches=counts[0], peak_bytes=peak)


# ---------------------------------------------------------------------------
# the locomotion-capability gate and the research scripts
# ---------------------------------------------------------------------------
SWEEP_STEPS = 300
SURVIVAL_STEPS = 100
DIAG_HLP_STEPS = 100
TRACKING_ENVS = 2048


def phase_capability(dev):
    """The three gates of scripts/torch_capability.py at the JAX test's
    sizes and thresholds; each raises when it fails."""
    t0 = phase_start()
    gate = script("torch_capability.py")
    zero_counts()
    trot = gate.gate_trot(str(dev))
    fl = gate.gate_flagship(str(dev))
    walk = gate.gate_walks(str(dev))
    counts = read_counts()
    check_counts("capability", counts, plane=3 * gate.STEPS
                 * fl["env"].cfg.control.decimation)
    finite_state("capability", fl["state"])
    finite_state("capability", walk["state"])
    say("capability", f"trot dx {trot['dx']:+.3f} m (|dx| >= {gate.TROT_MIN_DX}),"
        f" dones {trot['dones']:.0f}, final z {trot['z']:.3f} m (in "
        f"{gate.TROT_Z}); flagship median dx {fl['median']:.3f} m (>= "
        f"{gate.FLAGSHIP_MIN_MEDIAN_DX}); ab7 top-4 mean speed "
        f"{walk['top4']:.3f} m/s (> {gate.WALK_MIN_TOP4_SPEED}); "
        f"{counts[0]} plane-variant launches")
    k = hold_on_env("capability", fl["env"], fl["state"])
    peak = phase_end("capability", t0, counts[0])
    k.update(launches=counts[0], peak_bytes=peak, trot=trot,
             median=fl["median"], top4=walk["top4"])
    return k


def phase_drift_sweep(dev):
    """exp_drift_sweep_cuda.py's 72 points, one arm, SWEEP_STEPS steps."""
    import numpy as np
    t0 = phase_start()
    mod = script("exp_drift_sweep_cuda.py")
    P = mod.sweep_params()
    fit, patch = mod.ARMS[0]
    zero_counts()
    dx, nd, z, ok = mod.run_arm(fit, patch, P, steps=SWEEP_STEPS,
                                device=str(dev))
    counts = read_counts()
    check_counts("drift-sweep", counts, plane=SWEEP_STEPS * 4)
    if P.shape[0] != 72 or not (np.isfinite(dx).all()
                                and np.isfinite(z).all()):
        raise AssertionError(f"drift-sweep: {P.shape[0]} points, finite "
                             f"{np.isfinite(dx).all()}")
    say("drift-sweep", f"{P.shape[0]} points x {SWEEP_STEPS} steps "
        f"({fit}, r={patch}): {counts[0]} plane-variant launches; alive "
        f"{int(ok.sum())}/{len(ok)}, dx in [{dx.min():+.3f}, "
        f"{dx.max():+.3f}] m")
    peak = phase_end("drift-sweep", t0, counts[0])
    return dict(launches=counts[0], peak_bytes=peak, alive=int(ok.sum()),
                best_fwd=float(np.where(ok, dx, -np.inf).max()),
                best_bwd=float(np.where(ok, dx, np.inf).min()))


def phase_survival(dev):
    """diag_survival_cuda.py on the flagship config at 4000 envs (trimesh,
    full DR): zero and Gaussian actions, SURVIVAL_STEPS steps each."""
    import numpy as np
    t0 = phase_start()
    mod = script("diag_survival_cuda.py")
    env, cfg = mod.build_env(N_MC, False, False, str(dev))
    if (cfg.terrain.mesh_type != "trimesh"
            or not cfg.domain_rand.randomize_friction):
        raise AssertionError("survival: not the flagship's trimesh and DR")
    zero_counts()
    ends = {}
    for label, std, seed in (("zero actions", 0.0, 0),
                             ("random policy std=1.0", 1.0, 7)):
        outs, state = mod.run(env, SURVIVAL_STEPS, std, seed=seed)
        mod.summarize(env, outs, label)
        if not np.isfinite(outs["base_z"]).all():
            raise AssertionError(f"survival: {label}: base z not finite")
        d = outs["done"] & ~outs["timeout"]
        ends[label] = (int(outs["done"].sum()), int(d.sum()))
    counts = read_counts()
    check_counts("survival", counts, terrain=2 * SURVIVAL_STEPS
                 * cfg.control.decimation)
    finite_state("survival", state)
    say("survival", f"{N_MC} envs x {SURVIVAL_STEPS} steps an arm: "
        f"{counts[1]} terrain-variant launches; (episode ends, contact "
        f"terminations): {ends}")
    k = hold_on_env("survival", env, state)
    peak = phase_end("survival", t0, counts[1])
    k.update(launches=counts[1], peak_bytes=peak, ends=ends)
    return k


def phase_terrain_arms(dev):
    """bench_terrain_cuda.py at 4000 envs, one timed scan an arm."""
    t0 = phase_start()
    mod = script("bench_terrain_cuda.py")
    zero_counts()
    res = mod.main(["--num-envs", str(N_MC), "--iters", "1", "--device",
                    str(dev)])
    counts = read_counts()
    per_arm = 2 * mod.STEPS * 4           # the warm-up and the timed scan
    check_counts("terrain-arms", counts, plane=per_arm,
                 terrain=3 * per_arm)
    say("terrain-arms", ", ".join(
        f"{arm} {ms:.1f} ms ({N_MC * mod.STEPS / ms * 1e3:.0f} env-steps/s, "
        f"window {win})" for arm, (ms, win) in res.items())
        + f" | {card_line()}")
    peak = phase_end("terrain-arms", t0, counts[0] + counts[1])
    return dict(launches_plane=counts[0], launches_terrain=counts[1],
                peak_bytes=peak, ms={a: ms for a, (ms, _) in res.items()})


def phase_diag_hlp(dev):
    """diag_hlp_cuda.py's three arms, 16 envs, DIAG_HLP_STEPS steps."""
    import numpy as np
    import torch
    t0 = phase_start()
    mod = script("diag_hlp_cuda.py")
    zero_counts()
    env, out = mod.main(["--ll-run", LL_RUN, "--num-envs", "16", "--steps",
                         str(DIAG_HLP_STEPS), "--device", str(dev)])
    counts = read_counts()
    check_counts("diag-hlp", counts, terrain=3 * DIAG_HLP_STEPS
                 * env.ll_env.cfg.control.decimation)
    for arm, r in out.items():
        finite_state("diag-hlp", r["state"].ll)
        if not torch.isfinite(r["state"].obs).all():
            raise AssertionError(f"diag-hlp: {arm}: observations not finite")
    say("diag-hlp", f"3 arms x {DIAG_HLP_STEPS} steps x 16 envs: "
        f"{counts[1]} terrain-variant launches; (falls, goals, median max "
        f"x): " + ", ".join(f"{a} ({r['falls'].sum()}, {r['goals']}, "
                            f"{np.median(r['max_x']):.2f})"
                            for a, r in out.items()))
    peak = phase_end("diag-hlp", t0, counts[1])
    return dict(launches=counts[1], peak_bytes=peak)


def phase_tracking_only(dev):
    """exp_tracking_only_cuda.py: 2048 envs, 2 iterations."""
    t0 = phase_start()
    mod = script("exp_tracking_only_cuda.py")
    cfg = mod.tracking_only_cfg()
    if cfg.env.num_envs != TRACKING_ENVS:
        raise AssertionError(f"tracking-only: {cfg.env.num_envs} envs")
    zero_counts()
    runner = mod.run(ITERATIONS, 0.0, run_dir("tracking_only"),
                     device=str(dev), cfg=cfg)
    counts = read_counts()
    check_counts("tracking-only", counts, plane=ITERATIONS * HORIZON
                 * cfg.control.decimation)
    check_finite("tracking-only", runner)
    m = runner.last_metrics
    steps_s = [HORIZON * TRACKING_ENVS / (x["rollout_s"] + x["update_s"])
               for x in runner.timings]
    say("tracking-only", f"{ITERATIONS} iterations x {TRACKING_ENVS} envs: "
        f"{counts[0]} plane-variant launches; value loss "
        f"{m['mean_value_loss']:.4f}, surrogate "
        f"{m['mean_surrogate_loss']:.4f}, KL {m['kl']:.4f}, LR "
        f"{m['lr']:.3g}; env-steps/s per iteration "
        + ", ".join(f"{x:.0f}" for x in steps_s))
    peak = phase_end("tracking-only", t0, counts[0])
    return dict(launches=counts[0], peak_bytes=peak, env_steps_per_s=steps_s)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    # a rank of the sharded phase; the smoke run itself takes no argument
    ap.add_argument("--sharded-rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    if args.sharded_rank is not None:
        sharded_worker(args.sharded_rank, args.world, args.port, args.out,
                       args.device)
        return 0
    dev = phase_device()
    build_s = phase_build()
    k1 = phase_kernel(dev)
    tc, grid = mix_grid("terrain", dev)
    kt = phase_terrain(dev, tc, grid)
    kw = phase_world(dev, tc, grid, N_HLP, "world")
    phase_world(dev, tc, grid, N_MC, "world-4000")
    kl = phase_variant(dev, tc, grid, "legacy", fixed_base=False)
    kf = phase_variant(dev, tc, grid, "fixed-base", fixed_base=True)
    kv = phase_variants(dev, tc, grid)
    ro = phase_rollout(dev)
    gl = phase_go1_legacy(dev)
    tr = phase_train(dev)
    cl = phase_corridor_legacy(dev)
    ev = phase_env_variants(dev)
    sh = phase_sharded(dev)
    hl = phase_hlp(dev)
    hw = phase_hlp_world(dev)
    new = [phase_play(dev), phase_test(dev), phase_eval(dev),
           phase_hlp_play(dev)]
    aos = phase_aos(dev, tc, grid)
    aos_train = phase_aos_train(dev)
    mj = phase_mjcf(dev)
    hs = phase_heights(dev, tc, grid)
    del grid
    ve = phase_vecenv(dev)
    cap = phase_capability(dev)
    sw = phase_drift_sweep(dev)
    sv = phase_survival(dev)
    ta = phase_terrain_arms(dev)
    dh = phase_diag_hlp(dev)
    to = phase_tracking_only(dev)
    say("result", "all phases passed")
    say("result", "AoS step (plain PyTorch) ms/call at 4000 envs: "
        + ", ".join(f"{cm} {aos[cm]['ms']:.1f} ({aos[cm]['ops']} aten "
                    f"operations, {aos[cm]['kernels'] or 'not measured'} "
                    f"CUDA kernels)" for cm in ("apparent", "legacy"))
        + f"; AoS flagship iteration {aos_train['env_steps_per_s']:.0f} "
        f"env-steps/s; K1 plane on the MJCF end state "
        f"{mj['ms']:.4f} ms/launch (plain {mj['plain_ms']:.1f}, bound "
        f"{mj['bound_ms']:.5f}), max |err| {mj['max_abs_err']:.3g}")
    held = {"plane": k1, "terrain": kt, "world": kw, "legacy": kl,
            "fixed_base": kf, **kv}
    say("result", "K1 ms/launch at the main path's width | at 1024 envs "
        "(nvcc s): " + ", ".join(
            f"{v} {held[v]['ms']:.4f} | {held[v]['ms_1024']:.4f} "
            f"({build_s[v]:.1f})" for v in VARIANTS))
    say("result", "K1 terrain on the evaluation entries' end states: "
        + ", ".join(f"{name} N={k['n']}: {k['launches']} launches, "
                    f"{k['ms']:.4f} ms/launch (plain {k['plain_ms']:.1f}, "
                    f"bound {k['bound_ms']:.5f}), max |err| "
                    f"{k['max_abs_err']:.3g}, {k['s_per_step']:.4f} s/step"
                    for name, k in zip(("play", "test", "eval", "hlp-play"),
                                       new)))
    say("result", f"sharded flagship iteration at 4000 envs: one process "
        f"{sh['one']:.3f}s, two gloo ranks on one card {sh['two']:.3f}s")
    say("result", "K1 on the research phases' end states: " + ", ".join(
        f"{name} N={k['n']}: {k['launches']} launches, {k['ms']:.4f} "
        f"ms/launch (plain {k['plain_ms']:.1f}, bound {k['bound_ms']:.5f}), "
        f"max |err| {k['max_abs_err']:.3g}"
        for name, k in (("capability", cap), ("survival", sv)))
        + "; terrain arms ms per 24-step scan: " + ", ".join(
            f"{a} {v:.1f}" for a, v in ta["ms"].items()))
    launches = {
        "plane": ro["launches"] + mj["launches"] + ve["launches"]
        + cap["launches"] + sw["launches"] + ta["launches_plane"]
        + to["launches"],
        "terrain": tr["launches"] + hl["launches"]
        + sum(k["launches"] for k in new) + hs["launches"]
        + sv["launches"] + ta["launches_terrain"] + dh["launches"],
        "world": hw["launches"], "legacy": kl["launches"],
        "fixed_base": kf["launches"], "plane_legacy": gl["launches"],
        "terrain_world_legacy": cl["launches"], **ev}
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    kernels = [{
        "name": CP.variant_name(VARIANT_OF[v]),
        "route": "cuda",
        "source": "rapid_locomotion_rl_tpu_torch/csrc/physics_step.cu",
        "replaces": "rapid_locomotion_rl_tpu/ops/pallas_physics.py:61",
        "launches": launches[v],
        "max_abs_err": held[v]["max_abs_err"],
        "ms": held[v]["ms"],
        "plain_ms": held[v]["plain_ms"],
        "bound_ms": held[v]["bound_ms"],
        "bound_by": held[v]["bound_by"],
        "library_ms": None,
    } for v in VARIANTS]
    missing = [k["name"] for k in kernels if not k["launches"]]
    if missing:
        raise AssertionError(f"variants not launched on a path: {missing}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
