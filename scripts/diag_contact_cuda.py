"""Contact-model diagnostic on the PyTorch/CUDA port (the port of
scripts/diag_contact.py, plus ``--device``): stance slip, penetration and
achieved velocity of a trained flagship policy at fixed commanded speeds.

Hypothesis under test (VERDICT round 2, #2): the implicit per-geom contact
solve discounts forces by 1/(1 + c*dt/m_eff) with m_eff = calf mass, which
softens static normal stiffness and caps tangential force transfer, so the
policy cannot transmit the propulsion forces fast tracking needs without
large foot slip.

    python scripts/diag_contact_cuda.py [checkpoint.pkl] [--device cuda|cpu]

The checkpoint is a JAX-layout ``ac_weights`` file (default
runs/flagship4000's last). The physics runs as the CUDA kernel on the card
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

CKPT = "runs/flagship4000/checkpoints/ac_weights_003999.pkl"
SPEEDS = [0.4, 0.7, 1.0, 1.5]
N_PER = 16
STEPS = 300


def build_env(n, device="cuda"):
    """diag_contact.py's env: config_mini_cheetah flat, no noise, pushes,
    command curriculum or DR of friction, mass, CoM, motors and gains."""
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
    return LeggedRobotEnv(cfg, device=check_device(device))


def foot_contact(env, sim, feet_geoms):
    """Per env: the summed penetration and slip of the feet's spheres in
    contact with the plane (z = 0), and their count."""
    import torch
    from rapid_locomotion_rl_tpu_torch.ops.dynamics import (
        fk, geom_world_positions)
    gp, gv = geom_world_positions(env.model, fk(env.model, sim))
    r = torch.as_tensor(np.asarray(env.model.geom_radius, np.float32),
                        device=sim.q.device)[feet_geoms]
    pen = torch.clamp(r - gp[:, feet_geoms, 2], min=0.0)
    in_c = (pen > 0.0).float()
    slip = torch.linalg.norm(gv[:, feet_geoms, :2], dim=-1)
    return (torch.sum(pen * in_c, 1), torch.sum(slip * in_c, 1),
            torch.sum(in_c, 1))


def run(ckpt=CKPT, device="cuda"):
    """The policy's teacher at each speed of SPEEDS on N_PER envs each;
    per speed and over the second half of the STEPS steps: achieved vx,
    stance penetration, stance slip, the feet's summed normal force, and
    the dones of all steps. Returns the rows."""
    speeds, n_per, steps = SPEEDS, N_PER, STEPS
    import torch
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    from torch_capability import load_teacher
    env = build_env(n_per * len(speeds), device)
    m = env.model
    ac = load_teacher(env, ckpt)
    sampler = Sampler(0, env.device)
    state = env.initial_state(sampler)
    cmds = torch.tensor(speeds, device=env.device).repeat_interleave(n_per)
    commands = state.commands.clone()
    commands[:, 0] = cmds
    commands[:, 1:3] = 0.0
    state = state._replace(commands=commands)
    feet_geoms = [g for g in range(m.ng)
                  if int(m.geom_report_body[g]) in env.feet_indices]
    print(f"feet geoms: {len(feet_geoms)}; calf masses: "
          f"{np.asarray(m.mass)[np.asarray(m.geom_body)[feet_geoms]]}")
    feet = list(env.feet_indices)
    out = {k: [] for k in ("vx", "pen_sum", "slip_sum", "nc", "fn", "done")}
    with torch.no_grad():
        for _ in range(steps):
            a = ac.act_teacher(state.obs, state.privileged_obs)
            state, res = env.step(state, a, sampler)
            # re-pin commands (resampling is off but resets zero them)
            state = state._replace(commands=commands)
            pen, slip, nc = foot_contact(env, state.sim, feet_geoms)
            for k, v in (("vx", state.sim.base_lin_vel[:, 0]),
                         ("pen_sum", pen), ("slip_sum", slip), ("nc", nc),
                         ("fn", torch.sum(state.contact_report[:, feet, 2],
                                          1)),
                         ("done", res.done)):
                out[k].append(v)
    out = {k: torch.stack(v).cpu().numpy() for k, v in out.items()}
    half = steps // 2
    rows = []
    for i, v in enumerate(speeds):
        sl = slice(i * n_per, (i + 1) * n_per)
        vx = out["vx"][half:, sl].mean()
        nc = out["nc"][half:, sl]
        pen = out["pen_sum"][half:, sl].sum() / max(nc.sum(), 1)
        slip = out["slip_sum"][half:, sl].sum() / max(nc.sum(), 1)
        fn = out["fn"][half:, sl].mean()
        dones = out["done"][:, sl].sum()
        print(f"cmd vx={v:4.1f}: achieved {vx:6.3f} m/s "
              f"(err {v - vx:+.3f}) | stance pen {pen * 1000:5.1f} mm | "
              f"stance slip {slip:5.3f} m/s | feet Fz sum {fn:6.1f} N | "
              f"dones {dones}")
        rows.append(dict(cmd=v, vx=float(vx), pen=float(pen),
                         slip=float(slip), fn=float(fn), dones=int(dones)))
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint", nargs="?", default=CKPT)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return run(args.checkpoint, args.device)


if __name__ == "__main__":
    main()
