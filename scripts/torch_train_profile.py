#!/usr/bin/env python3
"""Where the time of the PyTorch port's flagship training iteration goes,
on one GPU.

    python3 scripts/torch_train_profile.py [--num-envs N] [--device cuda|cpu]

Builds the flagship env (config_mini_cheetah: 4000 envs, trimesh terrain)
on the card with the runs/r5_flagship policy, runs one warm-up training
iteration and one timed without the profiler (its rollout/update split),
then profiles the two halves of a third (learn/ppo.py's
make_train_functions) under torch.profiler: the 24-step rollout with GAE,
and the PPO update (5 epochs x 4 minibatches). For each
half it prints the wall time, the device time summed over all CUDA kernels
(profiler annotations such as the optimizer's step range left out) and its
share of the wall time (the device busy share; its complement is the idle
share), the kernel launches, and the top kernels by device time. Then it
takes one physics call on the final state apart: the kernels launched by
the terrain lookup that gives K1 its terrain rows (on the card its kernel,
csrc/geom_terrain.cu; on the CPU its plain version, the positions-only FK
and the gathers) and by the whole call, and their times by CUDA events
(median of 5, taken in turns), beside K1's own. A last line holds the
numbers as JSON, beside the card's name and power limit.

``--device cpu`` runs the same path on the CPU with the plain physics (a
rehearsal): its device times, kernel counts and K1's time print as "not
measured", and the host clock times the calls.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CALLS = 10      # physics calls in the profile that counts their kernels
WEIGHTS = os.path.join(ROOT, "runs", "r5_flagship", "checkpoints",
                       "ac_weights_last.pkl")
HORIZON = 24


def profiled(fn, on_card=True):
    """Run fn under torch.profiler; returns (fn's result, wall s, device ms,
    kernel launches, top kernels). Off the card: fn's result and wall s,
    None for the device's numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not on_card:
        t = time.time()
        out = fn()
        return out, time.time() - t, None, None, []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    by_name = {}
    for e in kernels:
        n, d = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, d + e.time_range.elapsed_us())
    dev_ms = sum(d for _, d in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return out, wall, dev_ms, len(kernels), [
        [name, n, d / 1e3] for name, (n, d) in top]


def time_ms(fn, on_card=True, reps=20):
    import torch
    fn()
    if not on_card:   # the CPU rehearsal: the host clock
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    import argparse

    import torch

    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.convert import params_from_flax
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.learn import ppo as P
    from rapid_locomotion_rl_tpu_torch.models.networks import ACArgs, ActorCritic
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    from rapid_locomotion_rl_tpu_torch.utils.checkpoint import load_pytree

    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=None,
                    help="envs (default: the flagship's 4000)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (K1 on the card) or cpu (its plain version)")
    opts = ap.parse_args(argv)
    dev = torch.device(opts.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card (or --device cpu)")
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip()
            if on_card else "CPU (not a card's figure)")
    cfg = config_mini_cheetah()
    if opts.num_envs is not None:
        cfg.env.num_envs = opts.num_envs
    n_envs = cfg.env.num_envs
    env = LeggedRobotEnv(cfg, device=dev)
    with open(os.path.join(os.path.dirname(os.path.dirname(WEIGHTS)),
                           "parameters.json")) as f:
        run = json.load(f)
    ac = ActorCritic(env.num_obs, env.num_privileged_obs,
                     env.num_obs_history, env.num_actions,
                     ACArgs(**run["AC_Args"])).to(dev)
    ac.load_state_dict(params_from_flax(load_pytree(WEIGHTS)["params"]))
    args = P.PPOArgs(**run["PPO_Args"])
    sampler = Sampler(0, dev)
    state = env.initial_state(sampler)
    ppo_state = P.init_ppo_state(ac, args)
    state, ppo_state, _ = P.train_iteration(env, ac, args, state, ppo_state,
                                            sampler, num_steps=HORIZON)
    timings = {}
    state, ppo_state, _ = P.train_iteration(env, ac, args, state, ppo_state,
                                            sampler, num_steps=HORIZON,
                                            timings=timings)
    step_ms = timings["rollout_s"] / HORIZON * 1e3

    rollout_gae, update = P.make_train_functions(env, ac, args, HORIZON)
    (state, traj, adv, ret, _), r_wall, r_dev, r_n, r_top = profiled(
        lambda: rollout_gae(state, sampler), on_card)
    _, u_wall, u_dev, u_n, u_top = profiled(
        lambda: update(ppo_state, traj, adv, ret, sampler), on_card)

    # the parts of one physics call on the final state
    grid = env.collision_grid
    layout = CP.check_supported(env.model, cfg.sim, terrain=grid)
    sim = state.sim
    params, imp, win = env.physics_inputs(state)
    gt = CP.geom_terrain_at(env.model, cfg.sim, layout, sim, grid, win)
    x = CP.pack_inputs(env.model, sim, state.torques, params, imp, grid, gt)
    y = torch.empty((CP.out_channels(env.model), n_envs), device=dev)
    cst = CP.KERNEL.table(env.model, cfg.sim, layout, dev)
    k1_ms = (time_ms(lambda: CP.KERNEL.launch_packed(x, y, cst, layout,
                                                     True, True), reps=50)
             if on_card else None)

    call_win = CP.lookup_window(cfg.sim, grid, sim.base_pos[:, 0],
                                sim.base_pos[:, 1], win)

    def lookup():
        """The lookup as the physics call runs it."""
        if on_card:
            CP.KERNEL.launch_geom_terrain(x, cst, layout, env.model.ng,
                                          CP.terrain_row(env.model, True),
                                          grid, call_win)
        else:
            CP.geom_terrain_at(env.model, cfg.sim, layout, sim, grid, win)

    def call():
        return CP.physics_step_cuda(
            env.model, cfg.sim, sim, state.torques, params, terrain=grid,
            implicit_damp=imp, terrain_window=win)

    # kernels per call, counted over CALLS calls in one profile: a short
    # profile after the long ones above was seen to miss a kernel (the
    # card's H100, torch 2.11), which per call would read as one too few
    lookup(), call()
    lookup_n = profiled(lambda: [lookup() for _ in range(CALLS)], on_card)[3]
    _, _, _, call_n, call_top = profiled(
        lambda: [call() for _ in range(CALLS)], on_card)
    lookup_n = lookup_n and lookup_n / CALLS
    call_n = call_n and call_n / CALLS
    lk, cl = [], []
    for _ in range(5):
        lk.append(time_ms(lookup, on_card))
        cl.append(time_ms(call, on_card))
    lookup_ms, call_ms = sorted(lk)[2], sorted(cl)[2]

    def nm(v, spec):
        return "not measured" if v is None else format(v, spec)

    print(f"card: {card}")
    for label, wall, dev_ms, n, top in (
            ("rollout+GAE", r_wall, r_dev, r_n, r_top),
            ("update", u_wall, u_dev, u_n, u_top)):
        print(f"{label}: {wall:.4f} s wall (with the profiler's cost), "
              f"device {nm(dev_ms, '.3f')} ms over {nm(n, 'd')} kernels, "
              f"busy share "
              f"{nm(dev_ms and dev_ms / 1e3 / wall * 100, '.1f')}%")
        for name, k, d in top:
            print(f"  {d:9.3f} ms {k:6d}x  {name[:90]}")
    d = cfg.control.decimation
    print(f"iteration without the profiler: rollout "
          f"{timings['rollout_s']:.3f} s ({step_ms:.1f} ms per env step), "
          f"update {timings['update_s']:.3f} s")
    print(f"rollout: {nm(r_n and r_n / HORIZON, '.0f')} kernels per env "
          f"step")
    print(f"physics call on the final state: {nm(call_n, 'g')} kernels, "
          f"{call_ms:.3f} ms; terrain lookup {nm(lookup_n, 'g')} kernels, "
          f"{lookup_ms:.3f} ms; K1 1 kernel, {nm(k1_ms, '.4f')} ms. x{d} per "
          f"env step: calls {call_ms * d / step_ms * 100:.1f}%, lookups "
          f"{lookup_ms * d / step_ms * 100:.1f}%, K1 "
          f"{nm(k1_ms and k1_ms * d / step_ms * 100, '.2f')}% of the env "
          f"step")
    for name, k, t in call_top:
        print(f"  physics call: {k / CALLS:g}x {name[:90]}")
    print(json.dumps({
        "card": card, "envs": n_envs, "steps": HORIZON,
        "rollout": {"wall_s": r_wall, "device_ms": r_dev, "kernels": r_n,
                    "busy_share": r_dev and r_dev / 1e3 / r_wall,
                    "top": r_top},
        "update": {"wall_s": u_wall, "device_ms": u_dev, "kernels": u_n,
                   "busy_share": u_dev and u_dev / 1e3 / u_wall,
                   "top": u_top},
        "iteration": timings, "env_step_ms": step_ms,
        "physics_call": {"kernels": call_n, "ms": call_ms},
        "terrain_lookup": {"kernels": lookup_n, "ms": lookup_ms},
        "k1_ms": k1_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
