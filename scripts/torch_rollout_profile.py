#!/usr/bin/env python3
"""Where the time of the PyTorch port's Go1 rollout goes, on one GPU.

    python3 scripts/torch_rollout_profile.py

Builds the Go1 env (config_go1, 4096 envs) on the card with the runs/r4_go1
policy, runs one warm-up horizon of 24 steps (one PPO horizon, as in
chip_smoke.py), then one profiled horizon under torch.profiler, and prints:
the horizon's wall time and env-steps/s, the device time summed over all
CUDA kernels and its share of the wall time (the device busy share; its
complement is the idle share), the number of kernel launches per env step,
and the top kernels by device time. A last line holds the same numbers as
JSON, beside the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WEIGHTS = os.path.join(ROOT, "runs", "r4_go1", "checkpoints",
                       "ac_weights_last.pkl")
HORIZON = 24


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rapid_locomotion_rl_tpu_torch.config import config_go1
    from rapid_locomotion_rl_tpu_torch.convert import params_from_flax
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.learn.ppo import PPOArgs, rollout
    from rapid_locomotion_rl_tpu_torch.models.networks import ACArgs, ActorCritic
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    from rapid_locomotion_rl_tpu_torch.utils.checkpoint import load_pytree

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = config_go1()
    n_envs = cfg.env.num_envs
    env = LeggedRobotEnv(cfg, device=dev)
    with open(os.path.join(os.path.dirname(os.path.dirname(WEIGHTS)),
                           "parameters.json")) as f:
        ac_args = ACArgs(**json.load(f)["AC_Args"])
    ac = ActorCritic(env.num_obs, env.num_privileged_obs,
                     env.num_obs_history, env.num_actions, ac_args).to(dev)
    ac.load_state_dict(params_from_flax(load_pytree(WEIGHTS)["params"]))
    sampler = Sampler(0, dev)
    state = env.initial_state(sampler)
    state, _, _ = rollout(env, ac, PPOArgs(), state, sampler, HORIZON)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t = time.time()
        state, traj, _ = rollout(env, ac, PPOArgs(), state, sampler,
                                 HORIZON)
        torch.cuda.synchronize()
        wall = time.time() - t

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        n, d = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, d + e.time_range.elapsed_us())
    dev_us = sum(d for _, d in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    print(f"card: {card}")
    print(f"horizon: {HORIZON} steps x {n_envs} envs in {wall:.4f} s "
          f"-> {HORIZON * n_envs / wall:.0f} env-steps/s "
          f"(wall includes the profiler's own cost)")
    print(f"device time {dev_us / 1e3:.3f} ms over {len(kernels)} kernels "
          f"({len(kernels) / HORIZON:.0f} per env step); busy share "
          f"{dev_us / 1e6 / wall * 100:.1f}% of the wall time")
    for name, (n, d) in top:
        print(f"  {d / 1e3:9.3f} ms {n:6d}x  {name[:90]}")
    print(json.dumps({
        "card": card, "envs": n_envs, "steps": HORIZON,
        "wall_s": wall, "env_steps_per_s": HORIZON * n_envs / wall,
        "device_ms": dev_us / 1e3, "kernels": len(kernels),
        "busy_share": dev_us / 1e6 / wall,
        "top": [[name, n, d / 1e3] for name, (n, d) in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
