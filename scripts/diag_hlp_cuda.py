"""HLP ground-truth diagnostic on the PyTorch/CUDA port (the port of
scripts/diag_hlp.py, same flags plus ``--device``): can the frozen
low-level policy survive and reach the goal under SCRIPTED high-level
commands?

  zero     : stand still (commands zeroed by the <0.2 norm gate)
  straight : vx=1.0 toward the goal (goal is at (3,0) -> dead ahead)
  pcontrol : P-controller: vx ~ clip(1.5*dist,0,2), yaw ~ heading error

    python scripts/diag_hlp_cuda.py [--ll-run runs/r4_flagship_4000]
        [--num-envs 16] [--steps 500] [--arms zero,straight,pcontrol]
        [--vx 1.0] [--device cuda|cpu]

The low level is ``--ll-run``'s config (no self resets, noise, pushes or
command curriculum) and student policy (its AC_Args, the params of its
train_state_last.pkl). The physics runs as the CUDA kernel on the card
(``--device cuda``, the default; the script raises when no card is
visible) or as its plain PyTorch version on the CPU (``--device cpu``).
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


def controller(name, obs, vx=1.0):
    """The scripted high-level command [N, 3] of arm ``name``."""
    import torch
    # obs = base_pos(3) + lin_vel(3) + ang_vel(3) + actions(3) + goal(2)
    pos = obs[:, 0:2]
    goal = obs[:, 12:14]
    delta = goal - pos
    dist = torch.linalg.norm(delta, dim=-1)
    if name == "zero":
        return torch.zeros((obs.shape[0], 3), device=obs.device)
    if name == "straight":
        return torch.stack([torch.full_like(dist, vx),
                            torch.zeros_like(dist),
                            torch.zeros_like(dist)], dim=-1)
    # pcontrol: command forward speed toward the goal; steer with yaw.
    heading = torch.atan2(delta[:, 1], delta[:, 0])
    v = torch.clip(1.5 * dist, 0.0, 2.0)
    return torch.stack([v, torch.zeros_like(dist),
                        torch.clip(2.0 * heading, -1.0, 1.0)], dim=-1)


def ll_env_and_policy(ll_run, num_envs, device):
    """The low-level env (``ll_run``'s config, no self resets, noise,
    pushes or command curriculum) and its frozen student."""
    from play_cuda import check_device, load_policy, run_cfg
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    cfg, blob = run_cfg(ll_run)
    cfg.env.num_envs = num_envs
    cfg.env.auto_reset = False
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.commands.command_curriculum = False
    ll_env = LeggedRobotEnv(cfg, device=check_device(device))
    return ll_env, load_policy(ll_run, ll_env, blob)


def run_arm(env, arm, steps, vx=1.0):
    """``steps`` HLP steps under the scripted arm from the initial state of
    Sampler(0). Returns the counters, as numbers and arrays, and the
    end state."""
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    sampler = Sampler(0, env.device)
    state = env.initial_state(sampler)
    N = env.num_envs
    falls = np.zeros(N, int)       # ll_done count per env
    timeouts = np.zeros(N, int)
    first_fall = np.full(N, -1, int)
    max_x = np.zeros(N)
    ep_len_hist = []
    cur_len = np.zeros(N, int)
    goals = 0
    for t in range(steps):
        state, res = env.step(state, controller(arm, state.obs, vx), sampler)
        done = res.done.cpu().numpy()
        # per-env terminal attribution comes from the info buffers
        to = res.info["time_outs"].cpu().numpy()
        ll_done = done & ~to
        falls += ll_done.astype(int)
        timeouts += to.astype(int)
        cur_len += 1
        for i in np.where(done)[0]:
            ep_len_hist.append(cur_len[i])
            cur_len[i] = 0
        newly = np.where(ll_done & (first_fall < 0))[0]
        first_fall[newly] = t
        max_x = np.maximum(max_x, state.obs[:, 0].cpu().numpy())
        goals += int(res.info["goal_reached_count"])
    ep_len = np.array(ep_len_hist) if ep_len_hist else np.array([steps])
    return dict(falls=falls, goals=goals, timeouts=timeouts,
                first_fall=first_fall, ep_len=ep_len, max_x=max_x,
                state=state)


def report(arm, r, steps, n):
    ff = r["first_fall"]
    print(f"[{arm}] steps={steps} envs={n}")
    print(f"  ll falls total      : {r['falls'].sum()}")
    print(f"  goals reached total : {r['goals']}")
    print(f"  timeouts total      : {r['timeouts'].sum()}")
    print(f"  first-fall step     : med "
          f"{np.median(ff[ff >= 0]) if (ff >= 0).any() else 'none'}")
    print(f"  episode len (steps) : med {np.median(r['ep_len']):.0f} "
          f"p90 {np.percentile(r['ep_len'], 90):.0f}")
    print(f"  max forward x       : med {np.median(r['max_x']):.2f} "
          f"max {r['max_x'].max():.2f}  (goal at 3.0)", flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ll-run", default="runs/r4_flagship_4000")
    ap.add_argument("--num-envs", type=int, default=16)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--arms", default="zero,straight,pcontrol")
    ap.add_argument("--vx", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns the HLP env and each arm's counters (with its end state)."""
    from rapid_locomotion_rl_tpu_torch.envs.hlp import HighLevelControlEnv
    args = parse_args(argv)
    ll_env, ll_ac = ll_env_and_policy(args.ll_run, args.num_envs,
                                      args.device)
    env = HighLevelControlEnv(ll_env, ll_ac)
    out = {}
    for arm in args.arms.split(","):
        out[arm] = run_arm(env, arm, args.steps, args.vx)
        report(arm, out[arm], args.steps, args.num_envs)
    return env, out


if __name__ == "__main__":
    main()
