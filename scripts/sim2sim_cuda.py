"""Sim2sim transfer check on the PyTorch/CUDA port (the port of
scripts/sim2sim.py, plus ``--device``): run the REFERENCE's trained
PyTorch policy (its rsl_rl ``ac_weights_last.pt``, trained in
IsaacGym/PhysX) inside this framework's physics.

If a policy trained in PhysX walks here at commanded speed, the dynamics
are RL-equivalent and any learning gap is on the algorithm side; if it
face-plants, the physics differs materially.

    python scripts/sim2sim_cuda.py [ckpt.pt] [--device cuda|cpu]

The default checkpoint is the reference example run's, at its path inside
the reference's ``runs/`` tree (``REF_CKPT``); pass the file's path. The
environment knobs of the JAX script hold: ``SIM2SIM_BASE_SPLIT``
(sim.contact_base_split), ``SIM2SIM_ITERS`` (sim.contact_iterations),
``SIM2SIM_FIT`` (asset.mesh_sphere_fit), ``SIM2SIM_PATCH``
(sim.torsional_patch_radius) and ``SIM2SIM_TEACHER=1`` (act by the teacher
on the true privileged observations). The physics runs as the CUDA kernel
on the card (``--device cuda``, the default; the script raises when no
card is visible) or as its plain PyTorch version on the CPU (``--device
cpu``).
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

REF_CKPT = ("runs/rapid-locomotion/example/train/201852.132488/checkpoints/"
            "ac_weights_last.pt")
SPEEDS = [0.4, 0.7, 1.0, 1.5, 2.0]
N_PER = 8
STEPS = 400
# rsl_rl's nn.Sequential keeps an activation between Linear layers: the
# i-th Linear of each MLP is entry 2 i (JAX scripts/sim2sim.py:30-49)
MLP_LAYERS = {"env_factor_encoder": 3, "adaptation_module": 3,
              "actor_body": 4, "critic_body": 4}


def reference_state_dict(sd):
    """An rsl_rl ActorCritic state dict -> the port's ActorCritic state
    dict. ``nn.Linear`` weights are [out, in] on both sides: taken as they
    are, not transposed."""
    import torch
    out = {"std": torch.as_tensor(sd["std"], dtype=torch.float32)}
    for prefix, n in MLP_LAYERS.items():
        for i in range(n):
            for leaf in ("weight", "bias"):
                out[f"{prefix}.layers.{i}.{leaf}"] = torch.as_tensor(
                    sd[f"{prefix}.{2 * i}.{leaf}"], dtype=torch.float32)
    return out


def load_reference_params(path):
    """The reference's checkpoint file -> the port's state dict."""
    import torch
    return reference_state_dict(torch.load(path, map_location="cpu"))


def reference_policy(env, path):
    """The port's ActorCritic (default ACArgs) with the reference's
    weights, on the env's device, frozen; load_state_dict checks every
    name and shape."""
    from rapid_locomotion_rl_tpu_torch.models.networks import (ACArgs,
                                                               ActorCritic)
    ac = ActorCritic(env.num_obs, env.num_privileged_obs,
                     env.num_obs_history, env.num_actions, ACArgs())
    ac.load_state_dict(load_reference_params(path))
    return ac.to(env.device).requires_grad_(False)


KNOBS = (("BASE_SPLIT", "sim", "contact_base_split", float),
         ("ITERS", "sim", "contact_iterations", int),
         ("FIT", "asset", "mesh_sphere_fit", str),
         ("PATCH", "sim", "torsional_patch_radius", float))


def knobs(cfg, prefix, names=("BASE_SPLIT", "ITERS", "FIT", "PATCH")):
    """The JAX script's environment knobs ``<prefix>_<name>`` for each of
    ``names`` applied to ``cfg``, each printed."""
    for name, section, field, cast in KNOBS:
        v = os.environ.get(f"{prefix}_{name}") if name in names else None
        if v:
            setattr(getattr(cfg, section), field, cast(v))
            print(f"{field}={getattr(getattr(cfg, section), field)}")
    return cfg


def build_env(n, device="cuda"):
    from play_cuda import check_device
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    cfg = config_mini_cheetah()
    cfg.env.num_envs = n
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.teleport_robots = False
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.randomize_com_displacement = False
    cfg.domain_rand.randomize_motor_strength = False
    cfg.domain_rand.randomize_Kp_factor = False
    cfg.domain_rand.randomize_Kd_factor = False
    cfg.commands.command_curriculum = False
    knobs(cfg, "SIM2SIM")
    return LeggedRobotEnv(cfg, device=check_device(device))


def run(ref_ckpt=REF_CKPT, device="cuda"):
    """The reference policy at each speed of SPEEDS on N_PER envs; per
    speed, over the second half of the STEPS steps: achieved vx, base
    height, the falls of all steps and the per-step tracking kernel.
    Returns the rows."""
    speeds, n_per, steps = SPEEDS, N_PER, STEPS
    import torch
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    env = build_env(n_per * len(speeds), device)
    ac = reference_policy(env, ref_ckpt)
    sampler = Sampler(0, env.device)
    state = env.initial_state(sampler)
    commands = state.commands.clone()
    commands[:, 0] = torch.tensor(speeds, device=env.device
                                  ).repeat_interleave(n_per)
    commands[:, 1:3] = 0.0
    state = state._replace(commands=commands)
    use_teacher = os.environ.get("SIM2SIM_TEACHER", "0") == "1"
    if use_teacher:
        print("policy path: act_teacher (true privileged obs; bypasses "
              "the obs-history/adaptation layout)")
    vx, done, h = [], [], []
    with torch.no_grad():
        for _ in range(steps):
            if use_teacher:
                a = ac.act_teacher(state.obs, state.privileged_obs)
            else:
                a = ac.act_student(state.obs, state.obs_history)
            state, res = env.step(state, a, sampler)
            state = state._replace(commands=commands)
            vx.append(state.sim.base_lin_vel[:, 0])
            done.append(res.done)
            h.append(state.sim.base_pos[:, 2])
    vx, done, h = (torch.stack(x).cpu().numpy() for x in (vx, done, h))
    half = steps // 2
    print(f"reference policy ({os.path.basename(ref_ckpt)}) in our sim:")
    rows = []
    for i, v in enumerate(speeds):
        sl = slice(i * n_per, (i + 1) * n_per)
        ach = vx[half:, sl].mean()
        falls = done[:, sl].sum()
        hh = h[half:, sl].mean()
        track = np.exp(-((v - vx[half:, sl]) ** 2) / 0.25).mean()
        print(f"cmd vx={v:4.1f}: achieved {ach:6.3f} m/s "
              f"(err {v - ach:+.3f}) | h {hh:.3f} | falls {falls:3d} | "
              f"per-step tracking {track:.2f}")
        rows.append(dict(cmd=v, vx=float(ach), h=float(hh),
                         falls=int(falls), tracking=float(track)))
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint", nargs="?", default=REF_CKPT)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return run(args.checkpoint, args.device)


if __name__ == "__main__":
    main()
