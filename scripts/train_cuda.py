"""Main training entry of the PyTorch/CUDA port (the port of
scripts/train.py, same flags, defaults and config overrides).

    python scripts/train_cuda.py [--robot mini_cheetah|go1] [--num-envs 4000]
                                 [--iterations 4000] [--logdir runs/...]
                                 [--resume .../train_state_last.pkl]
                                 [--device cuda|cpu]

The Runner trains the teacher-student PPO policy at 24 steps per env and
iteration, from random episode lengths, with eval-env resets and
curriculum dumps every ``--eval-freq`` iterations, checkpoints every 400
and at the end. ``--resume`` takes a train state written by this port or
by the JAX package (params, both Adam states, the adaptive LR, the env
state with its command curriculum, the iteration and the step count).
The physics runs as the CUDA kernel on the card (``--device cuda``, the
default; the script raises when no card is visible) or as its plain
PyTorch version on the CPU (``--device cpu``).

Every 400 iterations the Runner renders env 0's poses of the last
rollouts into ``videos/{it:05d}.gif`` (with Pillow), and each checkpoint
exports the student policy as ``student_policy_latest.pt2`` beside its
params. Three flags of scripts/train.py are left out: ``--physics-impl``
(a choice among the JAX package's physics back ends), ``--mesh`` and
``--distributed`` (sharding over several chips and processes); the port
runs on one card.
"""

import argparse
import os
import sys
from datetime import datetime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--robot", default="mini_cheetah",
                    choices=["mini_cheetah", "go1"])
    ap.add_argument("--num-envs", type=int, default=None)
    ap.add_argument("--iterations", type=int, default=4000)
    ap.add_argument("--eval-freq", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--resume", default=None,
                    help="path to a train_state checkpoint to resume from "
                         "(this port's or the JAX package's)")
    ap.add_argument("--entropy-coef", type=float, default=None,
                    help="override PPOArgs.entropy_coef")
    ap.add_argument("--entropy-warmup", type=int, default=None,
                    help="linear entropy-coef ramp 0 -> entropy_coef over "
                         "this many iterations")
    ap.add_argument("--min-std", type=float, default=None,
                    help="exploration floor on the learned action std "
                         "(0 = off)")
    ap.add_argument("--only-positive-rewards", type=int, default=None,
                    choices=[0, 1],
                    help="override cfg.rewards.only_positive_rewards")
    ap.add_argument("--substeps", type=int, default=None,
                    help="override cfg.sim.num_substeps")
    ap.add_argument("--implicit-pd", type=int, default=None, choices=[0, 1],
                    help="override cfg.sim.implicit_pd")
    ap.add_argument("--torsional-patch-radius", type=float, default=None,
                    help="override cfg.sim.torsional_patch_radius")
    ap.add_argument("--mesh-sphere-fit", default=None,
                    choices=["legacy", "hull"],
                    help="override cfg.asset.mesh_sphere_fit (hull = calf "
                         "sphere chain fitted to the collision-mesh hull)")
    ap.add_argument("--randomized-spawn", action="store_true",
                    help="legged_gym-style reset randomization (dof "
                         "0.5-1.5x default, root vel +-0.5)")
    ap.add_argument("--deterministic-spawn", action="store_true",
                    help="reset exactly at the default pose with zero root "
                         "velocity")
    ap.add_argument("--num-eval-envs", type=int, default=None)
    ap.add_argument("--terrain", default=None,
                    choices=["plane", "heightfield", "trimesh"],
                    help="override cfg.terrain.mesh_type")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def make_cfg(args):
    """The robot's config with the flags' overrides (scripts/train.py's)."""
    from rapid_locomotion_rl_tpu_torch.config import (config_go1,
                                                      config_mini_cheetah)
    cfg = (config_mini_cheetah() if args.robot == "mini_cheetah"
           else config_go1())
    cfg.seed = args.seed
    if args.num_envs is not None:
        cfg.env.num_envs = args.num_envs
    if args.num_eval_envs is not None:
        cfg.env.num_eval_envs = args.num_eval_envs
    if args.terrain is not None:
        cfg.terrain.mesh_type = args.terrain
        if args.terrain == "plane":
            cfg.terrain.teleport_robots = False
    if args.only_positive_rewards is not None:
        cfg.rewards.only_positive_rewards = bool(args.only_positive_rewards)
    if args.deterministic_spawn:
        cfg.init_state.dof_init_range = [1.0, 1.0]
        cfg.init_state.randomize_root_vel = False
    if args.randomized_spawn:
        cfg.init_state.dof_init_range = [0.5, 1.5]
        cfg.init_state.randomize_root_vel = True
    if args.substeps is not None:
        cfg.sim.num_substeps = args.substeps
    if args.implicit_pd is not None:
        cfg.sim.implicit_pd = bool(args.implicit_pd)
    if args.torsional_patch_radius is not None:
        cfg.sim.torsional_patch_radius = args.torsional_patch_radius
    if args.mesh_sphere_fit is not None:
        cfg.asset.mesh_sphere_fit = args.mesh_sphere_fit
    return cfg


def build_runner(args):
    """The env and its Runner (resumed when ``args.resume`` is set)."""
    from play_cuda import check_device
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.learn.ppo import PPOArgs
    from rapid_locomotion_rl_tpu_torch.learn.runner import Runner, RunnerArgs
    from rapid_locomotion_rl_tpu_torch.models.networks import ACArgs

    device = check_device(args.device)
    cfg = make_cfg(args)
    ppo_args = PPOArgs()
    if args.entropy_coef is not None:
        ppo_args.entropy_coef = args.entropy_coef
    if args.entropy_warmup is not None:
        ppo_args.entropy_warmup_iters = args.entropy_warmup
    ac_args = None
    if args.min_std is not None:
        ac_args = ACArgs(min_std=args.min_std)
    if args.logdir is None:
        stamp = datetime.now().strftime("%Y-%m-%d/%H%M%S.%f")
        args.logdir = f"runs/rapid-locomotion/{stamp}"

    env = LeggedRobotEnv(cfg, device=device)
    runner = Runner(env, logdir=args.logdir, seed=args.seed,
                    ac_args=ac_args, ppo_args=ppo_args,
                    runner_args=RunnerArgs(max_iterations=args.iterations,
                                           save_video_interval=400))
    if args.resume:
        runner.load_checkpoint(args.resume)
    return runner


def main(argv=None):
    args = parse_args(argv)
    runner = build_runner(args)
    print(f"training {args.robot} x{runner.env.num_envs} envs on "
          f"{runner.device} -> {args.logdir}")
    runner.learn(args.iterations, init_at_random_ep_len=True,
                 eval_freq=args.eval_freq)
    return runner


if __name__ == "__main__":
    main()
