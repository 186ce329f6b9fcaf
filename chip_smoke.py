#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Imports torch and the port (``rapid_locomotion_rl_tpu_torch``) only. Each
phase prints one flushed line with the seconds elapsed; a failed phase
raises and the script exits non-zero.

1. device:   a CUDA card, its name and power limit (nvidia-smi).
2. build:    nvcc builds the physics kernel (the five variants the port
             runs: the plane, terrain, terrain with world boxes, terrain
             with the legacy contact model, and terrain with the legacy
             contact model and a fixed base) from csrc/; ptxas's register,
             spill and stack lines; per variant, the CUDA runtime's shared
             bytes per env and per block, resident warps per SM, registers
             and local bytes per thread.
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
8. rollout:  the Go1 env (config_go1, 4096 envs, plane) with the
             runs/r4_go1 policy weights; one PPO horizon (24 steps) of
             teacher-policy rollout; outputs finite; the plane variant
             launched exactly 24 x decimation times; env-steps/s and peak
             memory.
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
             env-steps/s of the iteration and peak memory.
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
12. result:  the kernels line, the card line, and the contract line.
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
    """The library from csrc/, ptxas's lines for each instance, and what
    the CUDA runtime reports for each variant at its main path's table:
    shared bytes per env and per block, resident warps per SM, registers
    and local (stack) bytes per thread."""
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    from rapid_locomotion_rl_tpu_torch.ops.world import default_corridor
    t = time.time()
    CP.KERNEL.load()
    say("build", f"{time.time() - t:.2f}s -> {CP.KERNEL.library_path}")
    for line in CP.KERNEL.build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "stack",
                                   "Compiling entry")):
            say("build", "ptxas " + line.strip())
    go1_cfg, go1 = go1_model()
    mc_cfg, mc = robot(config_mini_cheetah)
    w = mc_cfg.world
    boxes = default_corridor(w.length, w.width, w.wall_height,
                             w.wall_thickness)
    for name, model, cfg, bx, kw in (
            ("plane", go1, go1_cfg, None, {}),
            ("terrain", mc, mc_cfg, None, dict(has_terrain=True)),
            ("world", mc, mc_cfg, boxes, dict(has_terrain=True,
                                              has_world=True)),
            ("legacy", mc, mc_cfg, None, dict(has_terrain=True, legacy=True)),
            ("fixed_base", mc, mc_cfg, None, dict(
                has_terrain=True, legacy=True, fixed_base=True))):
        layout = CP.check_supported(model, cfg.sim)
        n_cst = CP.pack_constants(model, cfg.sim, layout, bx).size
        o = CP.KERNEL.occupancy(n_cst, **kw)
        say("build", f"{name}: table {n_cst * 4} B, scratch "
            f"{o['scratch_bytes_per_env']} B/env, "
            f"{o['smem_bytes_per_block']} B shared/block of "
            f"{o['envs_per_block']} envs, {o['blocks_per_sm']} blocks = "
            f"{o['warps_per_sm']} warps/SM, {o['registers']} registers, "
            f"{o['local_bytes']} B local/thread")


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
    return Count.ops / n


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


def mostly_close(phase, name, a, b, atol, where=None, label="grounded"):
    """Bulk agreement: states on a contact-branch boundary flip on fp-level
    differences, so grounded states agree entry by entry only in bulk. The
    floor is 99% of entries within atol + 1e-3 |ref|: tighter than the 80%
    of tests/test_soa_physics.py's bulk rule, and borne out on these seeds
    (100% measured on the H100). ``where`` restricts the count to the
    entries it marks."""
    close = (a - b).abs() <= atol + 1e-3 * b.abs()
    if where is not None:
        close = close[where]
    ok = close.float().mean().item()
    say(phase, f"{label} {name}: {ok:.4f} of {close.numel()} within atol "
        f"{atol} (max |err| {(a - b).abs().max().item():.3g})")
    if not ok >= 0.99:
        raise AssertionError(f"{label} {name}: only {ok:.4f} < 0.99 agree")


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
                window=None, boxes=None, origins=None, fixed_base=False):
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
    base the kernel's base pose and velocities are checked exactly."""
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
    if terrain is not None:
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
        2)
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


def phase_kernel(dev):
    """The plane variant on Go1 at 4096 envs."""
    cfg, model = go1_model()
    return hold_kernel(
        "kernel", model, cfg.sim,
        lambda seed, air: random_inputs(model, N_ENVS, seed, air, dev),
        N_ENVS)


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
                  fixed_base=False):
    """The terrain variant on Mini Cheetah at 4000 envs over the default
    TerrainCfg mix, looked up through the env's column-block window; with
    ``legacy`` the legacy-contact variant, with ``fixed_base`` also the
    fixed base, held and timed on the same states."""
    import copy
    import numpy as np
    import torch
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.ops.contact import (
        blocked_window, terrain_height_bilinear)
    cfg, model = robot(config_mini_cheetah)
    sim = copy.deepcopy(cfg.sim)
    if legacy:
        sim.contact_model = "legacy"
    rng = np.random.default_rng(SEED)
    xy = torch.tensor(np.stack([
        rng.uniform(0.5, tc.num_rows * tc.terrain_length - 0.5, N_MC),
        rng.uniform(0.5, tc.num_cols * tc.terrain_width - 0.5, N_MC)], -1),
        dtype=torch.float32, device=dev)
    under = terrain_height_bilinear(grid, xy[:, 0], xy[:, 1])

    def make_inputs(seed, airborne):
        state, tau, params, imp = random_inputs(model, N_MC, seed, airborne,
                                                dev)
        pos = torch.cat([xy, state.base_pos[:, 2:] + under[:, None]], -1)
        return state._replace(base_pos=pos), tau, params, imp

    return hold_kernel(
        phase, model, sim, make_inputs, N_MC, terrain=grid,
        window=lambda s: blocked_window(grid, s.base_pos[:, 0],
                                        s.base_pos[:, 1]),
        fixed_base=fixed_base)


def phase_world(dev, tc, grid, n, phase):
    """The terrain + world variant on Mini Cheetah at ``n`` envs over the
    default TerrainCfg mix, in the default corridor (4 walls 1 m high
    around 3.5 x 1.6 m), each env's origin on the ground under its base,
    the base at x in [-1.95, 1.95] and |y| in [0.45, 0.95] from the origin,
    so that spheres clear, touch, cross and sit inside the walls.

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
    import numpy as np
    import torch
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    from rapid_locomotion_rl_tpu_torch.ops.contact import (
        blocked_window, terrain_height_bilinear)
    from rapid_locomotion_rl_tpu_torch.ops.soa_physics import physics_step_soa
    from rapid_locomotion_rl_tpu_torch.ops.world import default_corridor
    cfg, model = robot(config_mini_cheetah)
    boxes = default_corridor(cfg.world.length, cfg.world.width,
                             cfg.world.wall_height, cfg.world.wall_thickness)
    rng = np.random.default_rng(SEED + 1)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    xy = f(np.stack([
        rng.uniform(2.5, tc.num_rows * tc.terrain_length - 2.5, n),
        rng.uniform(2.5, tc.num_cols * tc.terrain_width - 2.5, n)], -1))
    rel = f(np.stack([rng.uniform(-1.95, 1.95, n),
                      rng.choice([-1.0, 1.0], n)
                      * rng.uniform(0.45, 0.95, n)], -1))
    under = terrain_height_bilinear(grid, xy[:, 0], xy[:, 1])
    origins = torch.cat([xy - rel, under[:, None]], -1).contiguous()

    def make_inputs(seed, airborne, lift=None):
        """Flight 2 m up by default: over the 1 m walls."""
        state, tau, params, imp = random_inputs(model, n, seed, airborne,
                                                dev)
        lift = 2.0 if airborne and lift is None else lift
        z = state.base_pos[:, 2] if lift is None else 0.0 * under + lift
        pos = torch.cat([xy, (z + under)[:, None]], -1)
        return state._replace(base_pos=pos), tau, params, imp

    def window(s):
        return blocked_window(grid, s.base_pos[:, 0], s.base_pos[:, 1])

    def both(state, tau, params, imp, walls=True):
        kw = dict(terrain=grid, implicit_damp=imp, terrain_window=window(state),
                  world_boxes=boxes if walls else None,
                  env_origin=origins if walls else None)
        out_k = (CP.physics_step_cuda(model, cfg.sim, state, tau, params, **kw)
                 if walls else None)
        torch.cuda.synchronize()
        return out_k, physics_step_soa(model, cfg.sim, state, tau, params,
                                       **kw)

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
    walled = make_inputs(3, True, lift=0.75)
    _, free = both(*walled, walls=False)
    out_k, out_p = both(*walled)
    err = 0.0
    for name in out_p.state._fields:
        a, b = getattr(out_k.state, name), getattr(out_p.state, name)
        if not torch.isfinite(a).all():
            raise AssertionError(f"wall flight {name}: non-finite output")
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5,
                                   msg=lambda m: f"wall flight {name}: {m}")
        err = max(err, (a - b).abs().max().item())
    wall = out_p.contact_report != free.contact_report
    if int(wall.sum()) == 0:
        raise AssertionError("flight in the walls: no wall force")
    torch.testing.assert_close(out_k.contact_report[wall],
                               out_p.contact_report[wall], rtol=2e-4,
                               atol=2e-3)
    rep_err = (out_k.contact_report - out_p.contact_report)[wall].abs().max()
    say(phase, f"flight in the walls: state max |err| {err:.3g} (rtol/atol"
        f" 2e-5); {int(wall.sum())} wall-force entries (max |f| "
        f"{out_p.contact_report.abs().max().item():.4g} N) within rtol 2e-4"
        f" / atol 2e-3 (max |err| {rep_err.item():.3g} N)")
    result = hold_kernel(
        phase, model, cfg.sim, make_inputs, n, terrain=grid,
        window=window, boxes=boxes, origins=origins)
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


VARIANTS = ("plane", "terrain", "world", "legacy", "fixed_base")


def zero_counts():
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    k = CP.KERNEL
    k.launches = k.terrain_launches = k.world_launches = 0
    k.legacy_launches = k.fixed_base_launches = 0


def read_counts():
    """Launches per variant since zero_counts, in the order of VARIANTS:
    plane, terrain, terrain + world, terrain + legacy contact, terrain +
    legacy contact + fixed base."""
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    k = CP.KERNEL
    return (k.launches - k.terrain_launches,
            k.terrain_launches - k.world_launches - k.legacy_launches,
            k.world_launches, k.legacy_launches - k.fixed_base_launches,
            k.fixed_base_launches)


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
    from rapid_locomotion_rl_tpu_torch.ops.dynamics import PhysParams
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
    dr = state.dr
    imp = (env.d_gains * dr.Kd_factors + env._dt_sub * env.p_gains
           * dr.Kp_factors) * dr.motor_strengths
    x = CP.pack_inputs(env.model, state.sim, state.torques, PhysParams(
        dr.friction, dr.restitution, dr.payloads, dr.com_displacements), imp)
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


def phase_train(dev):
    """scripts/train_cuda.py's main on the flagship (config_mini_cheetah,
    4000 envs, trimesh), resumed from runs/r5_flagship's full train state
    (params, both Adam states, LR, env state), ITERATIONS iterations into
    a scratch logdir."""
    import numpy as np
    import torch
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    from rapid_locomotion_rl_tpu_torch.ops.dynamics import PhysParams
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

    # the terrain variant alone on the flagship's own state and window
    grid = env.collision_grid
    state = runner.env_state
    layout = CP.check_supported(env.model, cfg.sim, terrain=grid)
    dr = state.dr
    imp = (env.d_gains * dr.Kd_factors + env._dt_sub * env.p_gains
           * dr.Kp_factors) * dr.motor_strengths
    win = env._window(grid, state.sim.base_pos[:, 0], state.sim.base_pos[:, 1])
    gt = CP.geom_terrain_at(env.model, cfg.sim, layout, state.sim, grid, win)
    x = CP.pack_inputs(env.model, state.sim, state.torques, PhysParams(
        dr.friction, dr.restitution, dr.payloads, dr.com_displacements), imp,
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
    for name, v in runner.env_state.ll.sim._asdict().items():
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
    from rapid_locomotion_rl_tpu_torch.ops.dynamics import PhysParams
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
    dr = ll.dr
    imp = (ll_env.d_gains * dr.Kd_factors + ll_env._dt_sub * ll_env.p_gains
           * dr.Kp_factors) * dr.motor_strengths
    pp = PhysParams(dr.friction, dr.restitution, dr.payloads,
                    dr.com_displacements)
    grid = ll_env.collision_grid
    win = ll_env._window(grid, ll.sim.base_pos[:, 0], ll.sim.base_pos[:, 1])
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


def main() -> int:
    dev = phase_device()
    phase_build()
    k1 = phase_kernel(dev)
    tc, grid = mix_grid("terrain", dev)
    kt = phase_terrain(dev, tc, grid)
    kw = phase_world(dev, tc, grid, N_HLP, "world")
    phase_world(dev, tc, grid, N_MC, "world-4000")
    kl = phase_variant(dev, tc, grid, "legacy", fixed_base=False)
    kf = phase_variant(dev, tc, grid, "fixed-base", fixed_base=True)
    del grid
    ro = phase_rollout(dev)
    tr = phase_train(dev)
    hl = phase_hlp(dev)
    hw = phase_hlp_world(dev)
    say("result", "all phases passed")
    say("result", "K1 ms/launch at the main path's width | at 1024 envs: "
        + ", ".join(f"{v} {k['ms']:.4f} | {k['ms_1024']:.4f}" for v, k in
                    zip(VARIANTS, (k1, kt, kw, kl, kf))))
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": "rapid_locomotion_rl_tpu_torch/csrc/physics_step.cu",
        "replaces": "rapid_locomotion_rl_tpu/ops/pallas_physics.py:61",
        "launches": launches,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,
    } for name, k, launches in (
        ("physics_step", k1, ro["launches"]),
        ("physics_step_terrain", kt, tr["launches"] + hl["launches"]),
        ("physics_step_terrain_world", kw, hw["launches"]),
        ("physics_step_terrain_legacy", kl, kl["launches"]),
        ("physics_step_terrain_legacy_fixed_base", kf, kf["launches"]))]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
