"""Isolation experiment on the PyTorch/CUDA port (the port of
scripts/exp_tracking_only.py, same arguments plus ``--device``): can PPO
learn velocity tracking when the reward is ONLY the tracking terms (no
penalties, no DR, no noise, flat ground)? Separates learner health from
reward-landscape and exploration effects.

    python scripts/exp_tracking_only_cuda.py [iters=300] [entropy_coef=0.0]
        [logdir=runs/exp_tracking_only] [--device cuda|cpu]

The Runner trains config_mini_cheetah at 2048 envs for ``iters``
iterations from random episode lengths, evaluating every 100, and writes
the run's metrics.jsonl, curriculum/info.pkl and checkpoints into
``logdir``. The physics runs as the CUDA kernel on the card (``--device
cuda``, the default; the script raises when no card is visible) or as its
plain PyTorch version on the CPU (``--device cpu``).
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from tune_trot_cuda import DR_FLAGS  # noqa: E402

TRACKING = ("tracking_lin_vel", "tracking_ang_vel")


def tracking_only_cfg(num_envs=2048):
    """config_mini_cheetah flat, with no noise, pushes or DR, and every
    reward scale but the two tracking terms zero."""
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    cfg = config_mini_cheetah()
    cfg.env.num_envs = num_envs
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.teleport_robots = False
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    for f in DR_FLAGS:
        setattr(cfg.domain_rand, f, False)
    sc = cfg.rewards.scales
    for name in list(vars(sc)):
        if not name.startswith("_") and name not in TRACKING:
            setattr(sc, name, 0.0)
    cfg.rewards.only_positive_rewards = False
    return cfg


def run(iters=300, ent=0.0, logdir="runs/exp_tracking_only", device="cuda",
        cfg=None):
    """Train ``cfg`` (default tracking_only_cfg()) for ``iters``
    iterations; returns the Runner."""
    from play_cuda import check_device
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.learn.ppo import PPOArgs
    from rapid_locomotion_rl_tpu_torch.learn.runner import Runner, RunnerArgs
    env = LeggedRobotEnv(cfg or tracking_only_cfg(),
                         device=check_device(device))
    runner = Runner(env, logdir=logdir, seed=0,
                    ppo_args=PPOArgs(entropy_coef=ent),
                    runner_args=RunnerArgs(max_iterations=iters,
                                           save_video_interval=0))
    runner.learn(iters, init_at_random_ep_len=True, eval_freq=100)
    return runner


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("iters", nargs="?", type=int, default=300)
    ap.add_argument("ent", nargs="?", type=float, default=0.0)
    ap.add_argument("logdir", nargs="?", default="runs/exp_tracking_only")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    return run(a.iters, a.ent, a.logdir, a.device)


if __name__ == "__main__":
    main()
