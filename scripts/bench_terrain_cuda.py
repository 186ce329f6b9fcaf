"""Terrain-lookup micro-bench on the PyTorch/CUDA port (the port of
scripts/bench_terrain.py, same flags plus ``--device``).

Times a 24-step scan of env.step (zero actions) of the flagship config
under each terrain-lookup setting of the JAX script:

  mm      : terrain_patch_size 16, terrain_lookup "mm"
  take    : terrain_patch_size 16, terrain_lookup "take"
  direct  : terrain_patch_size 0 (no window)
  plane   : no terrain (the floor the others race toward)

The port has one lookup, the bilinear sample of ops/contact.py; what the
settings change is the window of the grid that each physics call looks up
through (envs/legged_robot.py::_window_rule): the 32 x 128 column block
(mm on a grid that large), a (P + 8)-cell square (take), or none (direct:
the call centers its own P-cell square, or with P = 0 reads the whole
grid). The script prints each arm's window, and says so where two arms
get the same one.

    python scripts/bench_terrain_cuda.py [--num-envs 4000] [--iters 10]
        [--arms mm,take,direct,plane] [--device cuda|cpu]

Each scan starts from the same initial state (Sampler(0)); the warm-up
scan is not timed; the card is synchronized before and after the timed
scans. Prints ms per scan and env-steps/s per arm, and each arm's cost
over ``plane``. The physics runs as the CUDA kernel on the card
(``--device cuda``, the default; the script raises when no card is
visible) or as its plain PyTorch version on the CPU (``--device cpu``).
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

STEPS = 24


def arm_cfg(arm, num_envs):
    """config_mini_cheetah at ``num_envs`` with the arm's terrain setting
    (bench_terrain.py:60-75)."""
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    cfg = config_mini_cheetah()
    cfg.env.num_envs = num_envs
    if arm == "plane":
        cfg.terrain.mesh_type = "plane"
        cfg.terrain.teleport_robots = False
    elif arm == "mm":
        cfg.sim.terrain_patch_size = 16
        cfg.sim.terrain_lookup = "mm"
    elif arm == "take":
        cfg.sim.terrain_patch_size = 16
        cfg.sim.terrain_lookup = "take"
    elif arm == "direct":
        cfg.sim.terrain_patch_size = 0
    else:
        raise ValueError(f"unknown arm {arm!r}")
    return cfg


def window_of(env):
    """The window that the env's physics calls look the grid up through,
    as a (rows, cols) shape, or a word when there is none."""
    if env.collision_grid is None:
        return "no terrain"
    if env._window is None:
        P = int(getattr(env.cfg.sim, "terrain_patch_size", 0) or 0)
        return (f"none: each call centers a {P} x {P} square" if P > 0
                else "none: the whole grid")
    w = env._window(env.collision_grid, env.collision_grid.height.new_zeros(1),
                    env.collision_grid.height.new_zeros(1))
    return (w[2], w[3])


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_envstep(cfg, iters, log, label, device="cuda"):
    """ms per 24-step scan and the arm's window; ``iters`` timed scans."""
    import torch
    from play_cuda import check_device
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    env = LeggedRobotEnv(cfg, device=check_device(device))
    state0 = env.initial_state(Sampler(0, env.device))
    zero = torch.zeros((cfg.env.num_envs, env.num_actions), device=env.device)

    @torch.no_grad()
    def scan(state):
        sampler = Sampler(0, env.device)
        for _ in range(STEPS):
            state, res = env.step(state, zero, sampler)
        return res.rew

    scan(state0)
    sync(env.device)
    t0 = time.time()
    for _ in range(iters):
        scan(state0)
    sync(env.device)
    ms = (time.time() - t0) / iters * 1e3
    win = window_of(env)
    log(f"[terrain-bench] {label:8s} {ms:8.1f} ms  "
        f"({cfg.env.num_envs * STEPS / (ms / 1e3):,.0f} env-steps/s envstep)"
        f"  window {win}")
    return ms, win


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=4000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--arms", default="mm,take,direct,plane")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns {arm: (ms per scan, window)}."""
    args = parse_args(argv)
    log = lambda s: print(s, flush=True)  # noqa: E731
    results = {}
    for arm in args.arms.split(","):
        ms, win = time_envstep(arm_cfg(arm, args.num_envs), args.iters,
                               log, arm, args.device)
        same = [a for a, (_, w) in results.items() if w == win]
        if same:
            log(f"[terrain-bench] {arm}: the same window as {same[0]}")
        results[arm] = (ms, win)
    if "plane" in results:
        for arm, (ms, _) in results.items():
            if arm != "plane":
                log(f"[terrain-bench] {arm}: terrain cost "
                    f"{ms - results['plane'][0]:.1f} ms over plane")
    return results


if __name__ == "__main__":
    main()
