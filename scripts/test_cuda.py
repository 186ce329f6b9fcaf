"""Smoke test / install check of the PyTorch/CUDA port (the port of
scripts/test.py, reference scripts/test.py:14-53): a few Mini Cheetah
envs, fixed dynamics, zero actions for 1000 steps; the sim builds and
steps without NaN.

    python scripts/test_cuda.py [--device cuda|cpu]

The physics runs as the CUDA kernel on the card (``--device cuda``, the
default; the script raises when no card is visible) or as its plain
PyTorch version on the CPU (``--device cpu``).
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def run_env(num_envs=3, steps=1000, device="cuda"):
    """Step ``config_mini_cheetah`` with zero actions; every 100 steps
    print the mean reward and base height and assert the reward finite.
    Returns the env, its final state and the printed (step, reward,
    height) rows."""
    import numpy as np
    import torch
    from play_cuda import check_device
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler

    cfg = config_mini_cheetah()
    cfg.env.num_envs = num_envs
    # fixed dynamics, as in the reference smoke test (test.py:20-29)
    cfg.domain_rand.randomize_friction = True
    cfg.domain_rand.friction_range = [1.0, 1.01]
    cfg.domain_rand.randomize_base_mass = True
    cfg.domain_rand.added_mass_range = [0.0, 6.0]
    cfg.terrain.num_rows = 3
    cfg.terrain.num_cols = 3
    cfg.terrain.border_size = 5.0

    env = LeggedRobotEnv(cfg, device=check_device(device))
    sampler = Sampler(0, env.device)
    state = env.initial_state(sampler)
    actions = torch.zeros((num_envs, env.num_actions), device=env.device)
    rows = []
    with torch.no_grad():
        for i in range(steps):
            state, res = env.step(state, actions, sampler)
            if i % 100 == 0:
                rew = float(torch.mean(res.rew))
                z = float(torch.mean(state.sim.base_pos[:, 2]
                                     - state.env_origins[:, 2]))
                assert np.isfinite(rew), f"NaN reward at step {i}"
                print(f"step {i:4d} | mean rew {rew:7.4f} | mean height "
                      f"{z:.3f}", flush=True)
                rows.append((i, rew, z))
    print("smoke test passed")
    return env, state, rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None):
    return run_env(device=parse_args(argv).device)


if __name__ == "__main__":
    main()
