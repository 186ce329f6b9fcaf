"""HLP training entry of the PyTorch/CUDA port: train a 3-action
goal-navigation policy on top of a frozen low-level locomotion policy
loaded from a run (the port of scripts/high_level_play.py, same flags).

    python scripts/high_level_play_cuda.py --ll-run runs/r4_flagship_4000 \
        --min-std 0.2 --entropy-coef 0.0 --zero-reward-on-reset 0 \
        --progress-scale 1.0 --max-lr 1e-3 --dead-zone 0 --goal-radius 0.5

The high level is a tanh actor-critic without the latent branch, trained by
the Runner with PPO at 200 steps per env and iteration; 5% of the envs are
eval envs acting through the deterministic teacher. The low-level run's
``cfg.world`` is kept as its ``parameters.json`` gives it; ``--world``
switches its 4-wall corridor on around every env. The physics runs as
the CUDA kernel on the card (``--device cuda``, the default) or as its
plain PyTorch version on the CPU (``--device cpu``).
"""

import argparse
import glob
import json
import os
import sys
from datetime import datetime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def latest_run(root="runs/rapid-locomotion"):
    """The run whose train_state_last.pkl is newest (scripts/play.py's
    rule)."""
    ckpts = sorted(glob.glob(f"{root}/**/checkpoints/train_state_last.pkl",
                             recursive=True), key=os.path.getmtime)
    if not ckpts:
        raise FileNotFoundError(f"no runs under {root}")
    return os.path.dirname(os.path.dirname(ckpts[-1]))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=1024)
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--ll-run", default=None,
                    help="low-level run dir (default: latest under runs/)")
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--resume", default=None,
                    help="path to a HLP train_state checkpoint to resume "
                         "from (this port's or the JAX package's)")
    ap.add_argument("--min-std", type=float, default=0.0,
                    help="exploration floor on the action std")
    ap.add_argument("--zero-reward-on-reset", type=int, default=1,
                    choices=[0, 1],
                    help="1 (default) = the reference quirk: the reward of "
                         "a resetting env is zeroed after the terminal "
                         "rewards were added; 0 = terminal rewards visible")
    ap.add_argument("--progress-scale", type=float, default=0.0,
                    help="potential-based distance-progress shaping "
                         "(0 = reference parity)")
    ap.add_argument("--goal-radius", type=float, default=0.1,
                    help="goal tolerance in meters (reference 0.1)")
    ap.add_argument("--dead-zone", type=float, default=0.2,
                    help="xy-command zeroing threshold (reference 0.2); 0 "
                         "disables it")
    ap.add_argument("--action-magnitude-scale", type=float, default=0.0,
                    help="L2 penalty on commanded velocities (0 = "
                         "reference parity)")
    ap.add_argument("--max-lr", type=float, default=None,
                    help="cap of the adaptive-KL LR (reference 1e-2)")
    ap.add_argument("--entropy-coef", type=float, default=None,
                    help="override PPOArgs.entropy_coef (no warmup)")
    ap.add_argument("--world", action="store_true",
                    help="switch cfg.world's corridor on (a run whose "
                         "config has it on keeps it without the flag)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def low_level_cfg(cfg, args):
    """The low-level run's ``cfg`` under a high-level policy: no self
    resets, no noise, no pushes, no command curriculum; its ``cfg.world``
    as the run has it, switched on by ``--world``."""
    cfg.env.num_envs = args.num_envs
    cfg.env.auto_reset = False
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.commands.command_curriculum = False
    if args.world:
        cfg.world.enabled = True
    return cfg


def build_runner(args):
    """The frozen low-level env and policy, the HLP env and its Runner
    (resumed when ``args.resume`` is set)."""
    from rapid_locomotion_rl_tpu_torch.config import Cfg
    from rapid_locomotion_rl_tpu_torch.convert import params_from_flax
    from rapid_locomotion_rl_tpu_torch.envs.hlp import (HighLevelControlEnv,
                                                        HLPRewardScales)
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.learn.ppo import PPOArgs
    from rapid_locomotion_rl_tpu_torch.learn.runner import Runner, RunnerArgs
    from rapid_locomotion_rl_tpu_torch.models.networks import (ACArgs,
                                                               ActorCritic)
    from rapid_locomotion_rl_tpu_torch.utils.checkpoint import load_pytree

    ll_run = args.ll_run or latest_run()
    print(f"frozen low-level policy from {ll_run}")
    with open(os.path.join(ll_run, "parameters.json")) as f:
        blob = json.load(f)
    cfg = low_level_cfg(Cfg.from_dict(blob["Cfg"]), args)
    ll_env = LeggedRobotEnv(cfg, device=args.device)
    payload = load_pytree(
        os.path.join(ll_run, "checkpoints/train_state_last.pkl"))
    ll_ac = ActorCritic(ll_env.num_obs, ll_env.num_privileged_obs,
                        ll_env.num_obs_history, ll_env.num_actions,
                        ACArgs(**blob.get("AC_Args", {})))
    ll_ac.load_state_dict(params_from_flax(
        payload["ppo_state"].params["params"]))
    ll_ac = ll_ac.to(ll_env.device)

    class _Scales(HLPRewardScales):
        progress = args.progress_scale
        action_magnitude = args.action_magnitude_scale

    env = HighLevelControlEnv(
        ll_env, ll_ac, zero_reward_on_reset=bool(args.zero_reward_on_reset),
        scales=_Scales, dead_zone=args.dead_zone,
        goal_radius=args.goal_radius)
    # runner shims: the HLP env reuses the low-level config metadata
    env.cfg = ll_env.cfg
    env.derived = ll_env.derived

    if args.logdir is None:
        stamp = datetime.now().strftime("%Y-%m-%d/%H%M%S.%f")
        args.logdir = f"runs/rapid-locomotion/high_level/{stamp}"

    kw = {}
    if args.max_lr is not None:
        kw["max_lr"] = args.max_lr
    if args.entropy_coef is not None:
        kw["entropy_coef"] = args.entropy_coef
        kw["entropy_warmup_iters"] = 0
    runner = Runner(
        env, logdir=args.logdir,
        ac_args=ACArgs(activation="tanh", use_latent=False,
                       min_std=args.min_std),
        ppo_args=PPOArgs(**kw),
        runner_args=RunnerArgs(num_steps_per_env=200),
        eval_expert=True)
    if args.resume:
        runner.load_checkpoint(args.resume)
    return runner


def main(argv=None):
    args = parse_args(argv)
    runner = build_runner(args)
    runner.learn(args.iterations, eval_freq=200)
    return runner


if __name__ == "__main__":
    main()
