"""Checkpoint evaluation of the PyTorch/CUDA port (the port of
scripts/play.py, same flags plus ``--device``): load a run, build a 1-env
deterministic env, roll the student policy at a fixed forward command,
report the mean forward velocity and dump velocity-tracking plots.

    python scripts/play_cuda.py [--logdir runs/r4_flagship_4000]
                                [--steps 1000] [--vx 1.0]
                                [--gif out.gif] [--device cuda|cpu]

The env is the run's ``parameters.json`` config with the deployment
overrides of scripts/play.py (a 3 x 3-cell terrain with a 5 m border, no
terrain or command curriculum, no noise, no domain randomization or
pushes, the default pose at rest, 100 s episodes); the weights come from
the run's ``checkpoints/train_state_last.pkl`` (this port's or the JAX
package's). ``play.png`` is written beside the run when matplotlib is
there; ``--gif`` renders the rollout (:mod:`..utils.render`; needs
Pillow). The physics runs as the CUDA kernel on the card (``--device
cuda``, the default; the script raises when no card is visible) or as its
plain PyTorch version on the CPU (``--device cpu``).
"""

import argparse
import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def latest_run(root="runs/rapid-locomotion"):
    """The run whose train_state_last.pkl is newest."""
    ckpts = sorted(glob.glob(f"{root}/**/checkpoints/train_state_last.pkl",
                             recursive=True), key=os.path.getmtime)
    if not ckpts:
        raise FileNotFoundError(f"no runs under {root}")
    return os.path.dirname(os.path.dirname(ckpts[-1]))


def check_device(device):
    """The torch device; raises for ``cuda`` when no card is visible."""
    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --device cpu to "
                           "run the plain PyTorch physics on the CPU")
    return torch.device(device)


def run_cfg(logdir):
    """The run's Cfg and its parameters.json blob."""
    from rapid_locomotion_rl_tpu_torch.config import Cfg
    with open(os.path.join(logdir, "parameters.json")) as f:
        blob = json.load(f)
    return Cfg.from_dict(blob["Cfg"]), blob


def load_policy(logdir, env, blob):
    """The run's actor-critic (its AC_Args, the params of its
    train_state_last.pkl) on the env's device, frozen."""
    from rapid_locomotion_rl_tpu_torch.convert import params_from_flax
    from rapid_locomotion_rl_tpu_torch.models.networks import (ACArgs,
                                                               ActorCritic)
    from rapid_locomotion_rl_tpu_torch.utils.checkpoint import load_pytree
    payload = load_pytree(
        os.path.join(logdir, "checkpoints", "train_state_last.pkl"))
    ac = ActorCritic(env.num_obs, env.num_privileged_obs,
                     env.num_obs_history, env.num_actions,
                     ACArgs(**blob.get("AC_Args", {})))
    ac.load_state_dict(params_from_flax(
        payload["ppo_state"].params["params"]))
    return ac.to(env.device).requires_grad_(False)


def load_env(logdir, num_envs=1, device="cuda"):
    """The run's env with DR off (reference play.py:16-92) and its
    policy."""
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    cfg, blob = run_cfg(logdir)

    # deployment overrides (play.py:49-67)
    cfg.env.num_envs = num_envs
    cfg.terrain.num_rows = 3
    cfg.terrain.num_cols = 3
    cfg.terrain.border_size = 5.0
    cfg.terrain.curriculum = False
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.randomize_com_displacement = False
    cfg.domain_rand.randomize_motor_strength = False
    cfg.domain_rand.randomize_restitution = False
    cfg.domain_rand.push_robots = False
    cfg.init_state.dof_init_range = [1.0, 1.0]
    cfg.init_state.randomize_root_vel = False
    cfg.env.episode_length_s = 100.0
    cfg.commands.command_curriculum = False

    env = LeggedRobotEnv(cfg, device=check_device(device))
    return env, load_policy(logdir, env, blob)


def play(logdir=None, steps=1000, cmd=(1.0, 0.0, 0.0), plot=True,
         gif=None, device="cuda", gif_stride=2):
    """Roll the student policy at the fixed command ``cmd``. Returns a
    dict: ``mean_vx`` (the mean forward body velocity over the last 500
    steps), per-step NumPy arrays ``vx``, ``z`` (base height, world),
    ``height`` (base height above the env origin) and ``done``, the final
    ``state``, the ``env`` and the ``gif`` path written (or None)."""
    import numpy as np
    import torch
    from rapid_locomotion_rl_tpu_torch.ops import quat as Q
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler

    logdir = logdir or latest_run()
    print(f"loading {logdir}")
    env, ac = load_env(logdir, device=device)
    sampler = Sampler(0, env.device)
    state = env.initial_state(sampler)
    command = torch.tensor(cmd, dtype=torch.float32, device=env.device)

    # per-step logs stay on the device until the end: no sync in the loop
    vxs, qs, zs, hs, dones, poses = [], [], [], [], [], []
    with torch.no_grad():
        for _ in range(steps):
            commands = state.commands.clone()
            commands[:, :3] = command
            state = state._replace(commands=commands)
            actions = ac.act_student(state.obs, state.obs_history)
            state, res = env.step(state, actions, sampler)
            sim = state.sim
            vxs.append(Q.quat_rotate_inverse(sim.base_quat,
                                             sim.base_lin_vel)[0, 0])
            qs.append(sim.q[0])
            zs.append(sim.base_pos[0, 2])
            hs.append(sim.base_pos[0, 2] - state.env_origins[0, 2])
            dones.append(res.done[0])
            if gif:
                poses.append((sim.base_pos[0], sim.base_quat[0], sim.q[0],
                              state.env_origins[0]))
    host = lambda xs: torch.stack(xs).cpu().numpy()  # noqa: E731
    vxs, qs, zs, hs, dones = map(host, (vxs, qs, zs, hs, dones))

    out = None
    if gif:
        from rapid_locomotion_rl_tpu_torch.utils.render import (
            env_terrain, render_trajectory)
        pos, quat, qq, origin = (host([p[i] for p in poses])
                                 for i in range(4))
        out = render_trajectory(
            env.model, pos, quat, qq, origin, gif, stride=gif_stride,
            title=f"deterministic eval, cmd vx={cmd[0]:+.1f}",
            terrain=env_terrain(env))
        if out:
            print(f"video -> {out}")

    mean_vx = float(np.mean(vxs[-500:]))
    print(f"mean vx over last 500 steps: {mean_vx:.3f} m/s "
          f"(command {cmd[0]})")
    if plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError as e:
            print(f"plotting skipped: {e}")
        else:
            fig, axes = plt.subplots(3, 1, figsize=(8, 9))
            axes[0].plot(vxs)
            axes[0].axhline(cmd[0], ls="--", c="r")
            axes[0].set_ylabel("base vx [m/s]")
            axes[1].plot(qs)
            axes[1].set_ylabel("joint pos [rad]")
            axes[2].plot(zs)
            axes[2].set_ylabel("base z [m]")
            path = os.path.join(logdir, "play.png")
            fig.savefig(path, dpi=110)
            plt.close(fig)
            print(f"plots -> {path}")
    return dict(mean_vx=mean_vx, vx=vxs, z=zs, height=hs, done=dones,
                state=state, env=env, gif=out)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--vx", type=float, default=1.0)
    ap.add_argument("--gif", default=None,
                    help="render a camera-style GIF of the rollout here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    return play(a.logdir, a.steps, (a.vx, 0.0, 0.0), gif=a.gif,
                device=a.device)


if __name__ == "__main__":
    main()
