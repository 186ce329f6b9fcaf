"""Deterministic rollout probe of a trained HLP on the PyTorch/CUDA port
(the port of scripts/diag_hlp_rollout.py, same flags plus ``--device``):
per-step distance to goal, command magnitudes, achieved velocity and yaw
drift, the numbers that decide why goal reaches do (not) happen.

    python scripts/diag_hlp_rollout_cuda.py --hlp-run runs/r5_hlp7
        [--ll-run runs/r4_flagship_4000] [--num-envs 64] [--steps 500]
        [--dead-zone 0.2] [--stochastic] [--device cuda|cpu]

The high level is an ActorCritic of tanh layers without latent (the JAX
script's ACArgs) with the params of ``--hlp-run``'s train_state_last.pkl;
``--stochastic`` samples it (training behavior), one normal draw a step
from Sampler(1), as the JAX script splits PRNGKey(1) per step. The physics
runs as the CUDA kernel on the card (``--device cuda``, the default; the
script raises when no card is visible) or as its plain PyTorch version on
the CPU (``--device cpu``).
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hlp-run", required=True)
    ap.add_argument("--ll-run", default="runs/r4_flagship_4000")
    ap.add_argument("--num-envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--dead-zone", type=float, default=0.2)
    ap.add_argument("--stochastic", action="store_true",
                    help="sample the policy (training behavior) instead "
                         "of the deterministic mean")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def hlp_policy(env, hlp_run):
    from rapid_locomotion_rl_tpu_torch.convert import params_from_flax
    from rapid_locomotion_rl_tpu_torch.models.networks import (ACArgs,
                                                               ActorCritic)
    from rapid_locomotion_rl_tpu_torch.utils.checkpoint import load_pytree
    ac = ActorCritic(env.num_obs, env.num_privileged_obs,
                     env.num_obs_history, env.num_actions,
                     ACArgs(activation="tanh", use_latent=False))
    payload = load_pytree(os.path.join(hlp_run, "checkpoints",
                                       "train_state_last.pkl"))
    ac.load_state_dict(params_from_flax(
        payload["ppo_state"].params["params"]))
    return ac.to(env.device).requires_grad_(False)


def main(argv=None):
    """Returns the per-step arrays (dist, cmd, yawcmd, vx, yaw, done:
    [steps, N])."""
    import torch
    from diag_hlp_cuda import ll_env_and_policy
    from rapid_locomotion_rl_tpu_torch.envs.hlp import HighLevelControlEnv
    from rapid_locomotion_rl_tpu_torch.ops import quat as Q
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    args = parse_args(argv)
    ll_env, ll_ac = ll_env_and_policy(args.ll_run, args.num_envs,
                                      args.device)
    env = HighLevelControlEnv(ll_env, ll_ac, zero_reward_on_reset=False,
                              dead_zone=args.dead_zone)
    ac = hlp_policy(env, args.hlp_run)
    sampler = Sampler(0, env.device)
    noise = Sampler(1, env.device)
    state = env.initial_state(sampler)
    rows = {k: [] for k in ("dist", "cmd", "yawcmd", "vx", "yaw", "done")}
    with torch.no_grad():
        for _ in range(args.steps):
            priv = torch.zeros((state.obs.shape[0], env.num_privileged_obs),
                               device=env.device)
            if args.stochastic:
                mean, std = ac.distribution(state.obs, priv)
                a = mean + std * noise.normal("hlp_actions", mean.shape)
            else:
                a = ac.act_teacher(state.obs, priv)
            state, res = env.step(state, a, sampler)
            ll = state.ll
            q = ll.sim.base_quat
            # yaw from quaternion (z-rotation component)
            yaw = torch.atan2(2 * (q[:, 3] * q[:, 2] + q[:, 0] * q[:, 1]),
                              1 - 2 * (q[:, 1] ** 2 + q[:, 2] ** 2))
            for k, v in (
                    ("dist", torch.linalg.norm(env._base_pos(ll)[:, :2]
                                               - state.goal_position, dim=-1)),
                    ("cmd", torch.linalg.norm(a[:, :2], dim=-1)),
                    ("yawcmd", a[:, 2]),
                    ("vx", Q.quat_rotate_inverse(q, ll.sim.base_lin_vel)[:, 0]),
                    ("yaw", yaw), ("done", res.done.float())):
                rows[k].append(v)
    out = {k: torch.stack(v).cpu().numpy() for k, v in rows.items()}
    dist, cmd, yawcmd, vx, yaw, done = (out[k] for k in rows)
    print(f"probe {args.hlp_run}: {args.num_envs} envs x {args.steps} steps "
          f"({'stochastic' if args.stochastic else 'deterministic'})")
    for t in range(0, args.steps, max(args.steps // 10, 1)):
        print(f"t={t:4d} dist {dist[t].mean():5.2f}+-{dist[t].std():4.2f} "
              f"min {dist[t].min():4.2f} | |cmd| {cmd[t].mean():4.2f} "
              f"| yawcmd {yawcmd[t].mean():+5.2f} | vx {vx[t].mean():4.2f} "
              f"| yaw {np.abs(yaw[t]).mean():4.2f}")
    reached = (dist < 0.1).any(axis=0)
    print(f"envs that ever got within 0.1 m: {reached.sum()}/{args.num_envs}")
    print(f"min distance ever per env: mean {dist.min(axis=0).mean():.3f}, "
          f"median {np.median(dist.min(axis=0)):.3f}, "
          f"best {dist.min():.3f}")
    print(f"dones total {done.sum():.0f}")
    return out


if __name__ == "__main__":
    main()
