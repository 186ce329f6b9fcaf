"""Play a trained high-level policy (HLP) on the PyTorch/CUDA port (the
port of scripts/hlp_play.py, same flags plus ``--device``): roll the
goal-navigation policy over the frozen low-level stack, report goal-reach
statistics, and render a navigation GIF of the env that came closest to
the goal, with the goal marked (reference scripts/high_level_play.py play
path, :368-393).

    python scripts/hlp_play_cuda.py --hlp-run runs/r5_hlp7 \
        [--ll-run runs/r4_flagship_4000] [--num-envs 16] [--steps 500] \
        [--gif nav.gif] [--stochastic] [--device cuda|cpu]

The low level is ``--ll-run``'s config (no self resets, noise, pushes or
command curriculum) and student policy; the high level is ``--hlp-run``'s
``AC_Args`` and the params of its ``train_state_last.pkl``. By default the
HLP acts by its deterministic mean; ``--stochastic`` samples its training
distribution. The physics runs as the CUDA kernel on the card (``--device
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


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hlp-run", required=True)
    ap.add_argument("--ll-run", default="runs/r4_flagship_4000")
    ap.add_argument("--num-envs", type=int, default=16)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--gif", default=None)
    ap.add_argument("--dead-zone", type=float, default=0.2)
    ap.add_argument("--goal-radius", type=float, default=0.1)
    ap.add_argument("--stochastic", action="store_true",
                    help="sample the training distribution instead of "
                         "the deterministic mean")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def build(args):
    """The HLP env over the frozen low level, and the HLP policy."""
    from play_cuda import check_device, load_policy, run_cfg
    from rapid_locomotion_rl_tpu_torch.envs.hlp import HighLevelControlEnv
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv

    dev = check_device(args.device)
    cfg, ll_blob = run_cfg(args.ll_run)
    cfg.env.num_envs = args.num_envs
    cfg.env.auto_reset = False
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.commands.command_curriculum = False
    ll_env = LeggedRobotEnv(cfg, device=dev)
    ll_ac = load_policy(args.ll_run, ll_env, ll_blob)
    env = HighLevelControlEnv(ll_env, ll_ac, dead_zone=args.dead_zone,
                              goal_radius=args.goal_radius)
    _, hlp_blob = run_cfg(args.hlp_run)
    return env, load_policy(args.hlp_run, env, hlp_blob)


def main(argv=None):
    """Returns a dict: ``goals``, ``timeouts``, ``falls``, ``episodes``,
    the closest approach of each env ``min_dist``, the rendered env
    ``best_env``, the final ``state``, the ``env`` and the ``gif`` path
    written (or None)."""
    import numpy as np
    import torch
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler

    args = parse_args(argv)
    env, hlp_ac = build(args)
    ll_env = env.ll_env
    sampler = Sampler(0, env.device)
    noise = Sampler(2, env.device)
    state = env.initial_state(sampler)

    N = args.num_envs
    goals = torch.zeros((), dtype=torch.long, device=env.device)
    timeouts = torch.zeros_like(goals)
    episodes = torch.zeros_like(goals)
    poses = []          # all-env trajectories for the GIF
    dists = []
    with torch.no_grad():
        for _ in range(args.steps):
            # the deterministic policy mean (act_teacher == actor_body(obs)
            # without the latent branch, the HLP configuration), or a
            # sample from the training distribution with --stochastic
            if args.stochastic:
                mean, std = hlp_ac.distribution(state.obs,
                                                state.privileged_obs)
                act = mean + std * noise.normal("hlp_play/action",
                                                tuple(mean.shape))
            else:
                act = hlp_ac.act_teacher(state.obs, state.privileged_obs)
            state, res = env.step(state, act, sampler)
            dists.append(torch.linalg.norm(
                env._base_pos(state.ll)[:, :2] - state.goal_position,
                dim=-1))
            goals += res.info["goal_reached_count"]
            timeouts += res.info["time_outs"].sum()
            episodes += res.done.sum()
            if args.gif:
                ll = state.ll
                poses.append((ll.sim.base_pos, ll.sim.base_quat, ll.sim.q,
                              ll.env_origins))
    goals, timeouts, episodes = (int(x) for x in (goals, timeouts,
                                                  episodes))
    falls = max(0, episodes - goals - timeouts)
    dists = torch.stack(dists).cpu().numpy()      # [T, N]
    best_env = int(np.argmin(dists.min(axis=0)))  # closest approach
    print(f"[hlp_play] per-env closest approach: "
          f"{np.round(dists.min(axis=0), 2)} (render env {best_env})")
    print(f"[hlp_play] {args.steps} steps x {N} envs: "
          f"episodes={episodes} goals={goals} timeouts={timeouts} "
          f"falls={falls}")
    if episodes:
        print(f"[hlp_play] goal rate {goals / episodes * 100:.1f}% of "
              f"episodes")

    out = None
    if args.gif and poses:
        from rapid_locomotion_rl_tpu_torch.utils.render import (
            env_terrain, render_trajectory)
        pos, quat, qq, origin = (
            torch.stack([p[i][best_env] for p in poses]).cpu().numpy()
            for i in range(4))
        init = np.asarray(ll_env.cfg.init_state.pos)
        goal = env.goal.cpu().numpy()
        goal_w = origin[0] + init + np.array([goal[0], goal[1], 0.0])
        goal_w[2] = origin[0][2]
        out = render_trajectory(
            ll_env.model, pos, quat, qq, origin, args.gif, stride=3,
            title="HLP goal navigation (goal = star)",
            terrain=env_terrain(ll_env), marker=goal_w, view_half=2.4)
        if out:
            print(f"[hlp_play] video -> {out}")
    return dict(goals=goals, timeouts=timeouts, falls=falls,
                episodes=episodes, min_dist=dists.min(axis=0),
                best_env=best_env, state=state, env=env, gif=out)


if __name__ == "__main__":
    main()
