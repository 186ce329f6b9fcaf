"""Directional-asymmetry probe of a trained checkpoint on the PyTorch/CUDA
port (the port of scripts/exp_direction_probe.py, plus ``--device``):
command matched +-vx (and +-yaw) and compare what the policy achieves,
plus the torque cost of achieving it (EXPERIMENTS.md §14 measures the
backward preference at the scripted-gait level).

    python scripts/exp_direction_probe_cuda.py [logdir] [--device cuda|cpu]

The run is loaded as scripts/play_cuda.py loads it (its parameters.json
config with the deployment overrides, 4 envs, the student policy of its
train_state_last.pkl); ``PROBE_TEACHER=1`` acts by the teacher instead.
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

COMMANDS = ((1.0, 0, 0), (-1.0, 0, 0), (2.0, 0, 0), (-2.0, 0, 0),
            (0.5, 0, 0), (-0.5, 0, 0), (0, 0, 2.0), (0, 0, -2.0))


def rollout(env, ac, state, cmd, steps, settle, use_teacher):
    """``steps`` steps under the pinned command ``cmd`` from ``state`` with
    a fresh Sampler(0); means over steps ``settle``.. of the body-frame
    vx, the yaw rate and mean |torque|, and the number of dones."""
    import torch
    from rapid_locomotion_rl_tpu_torch.ops import quat as Q
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    from torch_capability import pinned
    sampler = Sampler(0, env.device)
    vx, wz, tq, done = [], [], [], []
    with torch.no_grad():
        for _ in range(steps):
            state = pinned(state, cmd)
            if use_teacher:
                actions = ac.act_teacher(state.obs, state.privileged_obs)
            else:
                actions = ac.act_student(state.obs, state.obs_history)
            state, res = env.step(state, actions, sampler)
            vx.append(Q.quat_rotate_inverse(state.sim.base_quat,
                                            state.sim.base_lin_vel)[:, 0])
            wz.append(state.sim.base_ang_vel[:, 2])
            tq.append(torch.mean(torch.abs(state.torques), dim=-1))
            done.append(res.done)
    sl = slice(settle, None)
    return (float(torch.stack(vx)[sl].mean()), float(torch.stack(wz)[sl].mean()),
            float(torch.stack(tq)[sl].mean()), int(torch.stack(done).sum()))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("logdir", nargs="?", default="runs/r3_flagship")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None, steps=250, settle=100):
    """Returns {command: (vx, wz, mean |tau|, dones)}."""
    from play_cuda import load_env
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    args = parse_args(argv)
    env, ac = load_env(args.logdir, num_envs=4, device=args.device)
    state0 = env.initial_state(Sampler(0, env.device))
    use_teacher = os.environ.get("PROBE_TEACHER", "0") == "1"

    print(f"checkpoint: {args.logdir}  (robot-frame means over steps "
          f"{settle}..{steps})")
    print(f"{'command':>22s} {'vx_ach':>8s} {'wz_ach':>8s} "
          f"{'mean|tau|':>9s} {'dones':>6s}")
    out = {}
    for cmd in COMMANDS:
        vx, wz, tq, nd = out[cmd] = rollout(env, ac, state0, cmd, steps,
                                            settle, use_teacher)
        print(f"{str(cmd):>22s} {vx:+8.3f} {wz:+8.3f} {tq:9.3f} {nd:6d}",
              flush=True)
    return out


if __name__ == "__main__":
    main()
