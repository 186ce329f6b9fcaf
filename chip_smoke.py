#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Imports torch and the port (``rapid_locomotion_rl_tpu_torch``) only. Each
phase prints one flushed line with the seconds elapsed; a failed phase
raises and the script exits non-zero.

1. device:  a CUDA card, its name and power limit (nvidia-smi).
2. build:   nvcc builds the physics kernel from csrc/; ptxas's register,
            spill and shared-memory lines.
3. kernel:  the kernel against its plain PyTorch version on Go1 at 4096
            envs, on states made from a numpy seed: torque-free flight at
            rtol/atol 2e-5 on state and 1e-5 on geom positions; grounded
            states with random torques: >= 99% of entries of every state
            field and of the non-zero contact forces within atol +
            1e-3 |ref|, geom positions at 1e-5; kernel and plain times by
            CUDA events.
4. rollout: the Go1 env (config_go1, 4096 envs) on the card with the
            runs/r4_go1 policy weights; one PPO horizon (24 steps) of
            teacher-policy rollout; outputs finite; the kernel launched
            exactly 24 x decimation times; env-steps/s and peak memory.
5. result:  the kernels line, the card line, and the contract line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

T0 = time.time()
N_ENVS = 4096
HORIZON = 24
SEED = 0
WEIGHTS = os.path.join("runs", "r4_go1", "checkpoints", "ac_weights_last.pkl")
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12     # fp32 outside the tensor cores


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
    from rapid_locomotion_rl_tpu_torch.ops.cuda_physics import KERNEL
    t = time.time()
    KERNEL.load()
    say("build", f"{time.time() - t:.2f}s -> {KERNEL.library_path}")
    for line in KERNEL.build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "stack",
                                   "Compiling entry")):
            say("build", "ptxas " + line.strip())


def go1_model():
    from rapid_locomotion_rl_tpu_torch import ROOT_DIR
    from rapid_locomotion_rl_tpu_torch.config import config_go1
    from rapid_locomotion_rl_tpu_torch.models import load_urdf
    cfg = config_go1()
    return cfg, load_urdf(cfg.asset.file.format(ROOT=ROOT_DIR),
                          armature=cfg.asset.armature,
                          mesh_sphere_fit=cfg.asset.mesh_sphere_fit)


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


def count_ops_per_env(model, sim_cfg, n=8):
    """Arithmetic operations per env of one physics call, counted from the
    plain version on the CPU: every elementwise aten op adds its output's
    element count (sin, sqrt, a comparison or a clamp count as one)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from rapid_locomotion_rl_tpu_torch.ops.soa_physics import physics_step_soa
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
    with Count():
        physics_step_soa(model, sim_cfg, state, tau, params,
                         implicit_damp=imp)
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


def mostly_close(name, a, b, atol, where=None):
    """Bulk agreement: states on a contact-branch boundary flip on fp-level
    differences, so grounded states agree entry by entry only in bulk. The
    floor is 99% of entries within atol + 1e-3 |ref|: tighter than the 80%
    of tests/test_soa_physics.py's bulk rule, and borne out on this seed
    (100% measured on the H100). ``where`` restricts the count to the
    entries it marks."""
    close = (a - b).abs() <= atol + 1e-3 * b.abs()
    if where is not None:
        close = close[where]
    ok = close.float().mean().item()
    say("kernel", f"grounded {name}: {ok:.4f} of {close.numel()} within atol "
        f"{atol} (max |err| {(a - b).abs().max().item():.3g})")
    if not ok >= 0.99:
        raise AssertionError(f"grounded {name}: only {ok:.4f} < 0.99 agree")


def phase_kernel(dev):
    import torch
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    from rapid_locomotion_rl_tpu_torch.ops.soa_physics import physics_step_soa
    cfg, model = go1_model()
    sim = cfg.sim
    result = {}

    # torque-free flight: no contact, no limit hits -> tight agreement
    state, tau, params, imp = random_inputs(model, N_ENVS, 3, True, dev)
    out_k = CP.physics_step_cuda(model, sim, state, tau, params,
                                 implicit_damp=imp)
    torch.cuda.synchronize()
    out_p = physics_step_soa(model, sim, state, tau, params,
                             implicit_damp=imp)
    torch.cuda.synchronize()
    err = 0.0
    for name in state._fields:
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
    say("kernel", f"flight N={N_ENVS}: state max |err| {err:.3g} "
        f"(rtol/atol 2e-5), geom_pos ok (1e-5)")
    result["max_abs_err"] = err

    # grounded states with random torques: bulk agreement
    state, tau, params, imp = random_inputs(model, N_ENVS, 0, False, dev)
    out_k = CP.physics_step_cuda(model, sim, state, tau, params,
                                 implicit_damp=imp)
    torch.cuda.synchronize()
    out_p = physics_step_soa(model, sim, state, tau, params,
                             implicit_damp=imp)
    torch.cuda.synchronize()
    if out_p.contact_report.abs().max().item() < 1.0:
        raise AssertionError("grounded case has no contact")
    for name in state._fields:
        atol = 1e-2 if name in ("qd", "base_lin_vel", "base_ang_vel") else 1e-3
        mostly_close(name, getattr(out_k.state, name),
                     getattr(out_p.state, name), atol)
    # most reported forces are zero on both sides: count the others only
    mostly_close("contact_report", out_k.contact_report, out_p.contact_report,
                 0.5, where=out_p.contact_report != 0)
    # geom positions are taken before the contact solve: strict
    torch.testing.assert_close(out_k.geom_pos, out_p.geom_pos, rtol=1e-5,
                               atol=1e-5)

    # times at the main path's shapes (grounded Go1, 4096 envs, imp on)
    layout = CP.check_supported(model, sim)
    cst = CP.KERNEL.table(model, sim, layout, dev)
    x = CP.pack_inputs(model, state, tau, params, imp)
    y = torch.empty((CP.out_channels(model), N_ENVS), device=dev)
    result["ms"] = time_ms(
        lambda: CP.KERNEL.launch_packed(x, y, cst, layout, True), 50)
    result["plain_ms"] = time_ms(
        lambda: physics_step_soa(model, sim, state, tau, params,
                                 implicit_damp=imp), 2)
    ops = count_ops_per_env(model, sim)
    nbytes = (x.numel() + y.numel() + cst.numel()) * 4
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops * N_ENVS / H100_FP32_OPS_PER_S * 1e3
    result.update(
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        ops_per_env=ops, bytes=nbytes, c_in=x.shape[0], c_out=y.shape[0])
    say("kernel", f"times N={N_ENVS}: kernel {result['ms']:.4f} ms/launch, "
        f"plain {result['plain_ms']:.1f} ms/call, bound "
        f"{result['bound_ms']:.4f} ms by {result['bound_by']} "
        f"({ops:.0f} ops/env, {nbytes} bytes, C_in {x.shape[0]}, "
        f"C_out {y.shape[0]})")
    return result


def phase_rollout(dev):
    import torch
    from rapid_locomotion_rl_tpu_torch.convert import params_from_flax
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.learn.ppo import PPOArgs, rollout
    from rapid_locomotion_rl_tpu_torch.models.networks import ACArgs, ActorCritic
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    from rapid_locomotion_rl_tpu_torch.ops.dynamics import PhysParams
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    from rapid_locomotion_rl_tpu_torch.utils.checkpoint import load_pytree
    cfg, _ = go1_model()
    if cfg.env.num_envs != N_ENVS:
        raise AssertionError(f"config_go1 has {cfg.env.num_envs} envs")
    t = time.time()
    env = LeggedRobotEnv(cfg, device=dev)
    with open(os.path.join(os.path.dirname(os.path.dirname(WEIGHTS)),
                           "parameters.json")) as f:
        ac_args = ACArgs(**json.load(f)["AC_Args"])
    ac = ActorCritic(env.num_obs, env.num_privileged_obs,
                     env.num_obs_history, env.num_actions, ac_args).to(dev)
    ac.load_state_dict(params_from_flax(load_pytree(WEIGHTS)["params"]))
    sampler = Sampler(SEED, dev)
    state = env.initial_state(sampler)
    torch.cuda.synchronize()
    say("rollout", f"Go1 env ({env.num_envs} envs, nv={env.model.nv}, "
        f"ng={env.model.ng}, nr={env.model.nr}) and {WEIGHTS} loaded in "
        f"{time.time() - t:.2f}s")

    # the main path: one PPO horizon through the kernel
    torch.cuda.reset_peak_memory_stats()
    CP.KERNEL.launches = 0
    t = time.time()
    state, traj, info = rollout(env, ac, PPOArgs(), state, sampler, HORIZON)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = CP.KERNEL.launches
    want = HORIZON * cfg.control.decimation
    if launches != want:
        raise AssertionError(f"kernel launched {launches} times, want {want}")
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


def main() -> int:
    dev = phase_device()
    phase_build()
    k1 = phase_kernel(dev)
    ro = phase_rollout(dev)
    say("result", "all phases passed")
    kernels = [{
        "name": "physics_step",
        "route": "cuda",
        "source": "rapid_locomotion_rl_tpu_torch/csrc/physics_step.cu",
        "replaces": "rapid_locomotion_rl_tpu/ops/pallas_physics.py:61",
        "launches": ro["launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
