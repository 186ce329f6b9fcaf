"""Propulsion forensics on the PyTorch/CUDA port (the port of
scripts/diag_propulsion.py, plus ``--device``): run the REFERENCE's
PhysX-trained policy (teacher path, true privileged obs; the checkpoint of
scripts/sim2sim_cuda.py) at a fixed forward command and measure, per
control step, where the propulsion goes:

- base vx (the outcome)
- per-foot normal force f_n and fore-aft tangential force f_t,x from the
  contact report (propulsion shows as positive mean f_t,x in stance)
- stance-foot slip: tangential speed of the foot contact point while
  loaded (stiction should pin it near zero)
- torque saturation fraction (are the actuators asked to push hard?)

    python scripts/diag_propulsion_cuda.py [cmd_vx] [--ckpt PATH]
        [--device cuda|cpu]

``DIAG_BASE_SPLIT``, ``DIAG_ITERS`` and ``DIAG_FIT`` set the contact base
split, iterations and sphere fit, as in the JAX script. The physics runs
as the CUDA kernel on the card (``--device cuda``, the default; the script
raises when no card is visible) or as its plain PyTorch version on the CPU
(``--device cpu``).
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

from sim2sim_cuda import REF_CKPT, knobs, reference_policy  # noqa: E402
from tune_trot_cuda import flat_no_dr  # noqa: E402

N = 8
STEPS = 300


def foot_geoms(m):
    """The foot-tip geoms: the lowest sphere of each calf."""
    out = []
    for b in range(m.nb):
        if "calf" in m.body_names[b]:
            gs = [g for g in range(m.ng) if int(m.geom_body[g]) == b]
            out.append(min(gs, key=lambda g: m.geom_offset[g][2]))
    return out


def run(cmd_vx=1.0, ref_ckpt=REF_CKPT, device="cuda"):
    """N envs for STEPS steps; returns the per-step outputs ([STEPS, ...]
    NumPy arrays)."""
    n, steps = N, STEPS
    import torch
    from play_cuda import check_device
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.ops.dynamics import (
        fk, geom_world_positions)
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    from torch_capability import pinned
    cfg = knobs(flat_no_dr(config_mini_cheetah(), n), "DIAG",
                ("BASE_SPLIT", "ITERS", "FIT"))
    env = LeggedRobotEnv(cfg, device=check_device(device))
    m = env.model
    ac = reference_policy(env, ref_ckpt)
    feet = list(env.feet_indices)
    fg = foot_geoms(m)
    dev = env.device
    body = torch.as_tensor(np.asarray(m.geom_body)[fg], device=dev).long()
    r = torch.as_tensor(np.asarray(m.geom_radius, np.float32)[fg],
                        device=dev)
    nvec = torch.tensor([0.0, 0.0, 1.0], device=dev)
    effort = torch.as_tensor(np.asarray(m.dof_effort, np.float32),
                             device=dev)
    sampler = Sampler(0, dev)
    state = env.initial_state(sampler)
    cmd = (cmd_vx, 0.0, 0.0)
    out = {k: [] for k in ("vx", "fn", "ftx", "slip", "foot_z", "tau_sat",
                           "done")}
    with torch.no_grad():
        for _ in range(steps):
            state = pinned(state, cmd)
            a = ac.act_teacher(state.obs, state.privileged_obs)
            state, res = env.step(state, a, sampler)
            # post-step foot kinematics
            frames = fk(m, state.sim)
            gp, gv = geom_world_positions(m, frames)
            # contact-point velocity: v + w x (p_c - p_center), n = +z
            w = frames.w[:, body]
            v_c = gv[:, fg] + torch.linalg.cross(
                w, (-nvec * r[:, None]).expand_as(w), dim=-1)
            rep = state.contact_report[:, feet]            # [N,4,3]
            for k, v in (("vx", state.sim.base_lin_vel[:, 0]),
                         ("fn", rep[..., 2]), ("ftx", rep[..., 0]),
                         ("slip", torch.linalg.norm(v_c[..., :2], dim=-1)),
                         ("foot_z", gp[:, fg, 2]),
                         ("tau_sat", torch.mean(torch.abs(state.torques)
                                                / effort, -1)),
                         ("done", res.done)):
                out[k].append(v)
    return {k: torch.stack(v).cpu().numpy() for k, v in out.items()}


def summarize(out, cmd_vx, n):
    steps = out["vx"].shape[0]
    half = steps // 2
    loaded = out["fn"][half:] > 5.0                     # stance mask
    print(f"reference teacher @ cmd vx={cmd_vx} ({n} envs, "
          f"steps {half}..{steps}):")
    print(f"  base vx        mean {out['vx'][half:].mean():+.3f} m/s")
    print(f"  dones          {out['done'].sum()}")
    print(f"  stance frac    {loaded.mean():.2f}  (per-foot share of time "
          f"with f_n>5N)")
    print(f"  f_n (stance)   mean {out['fn'][half:][loaded].mean():6.1f} N  "
          f"(4 feet x ~22 N = weight 88 N)")
    print(f"  sum f_n / env-step  {out['fn'][half:].sum(-1).mean():6.1f} N")
    print(f"  f_t,x (stance) mean {out['ftx'][half:][loaded].mean():+6.2f} N "
          f" p10 {np.percentile(out['ftx'][half:][loaded], 10):+6.2f} "
          f" p90 {np.percentile(out['ftx'][half:][loaded], 90):+6.2f}")
    print(f"  slip (stance)  mean {out['slip'][half:][loaded].mean():.3f} m/s"
          f"  p90 {np.percentile(out['slip'][half:][loaded], 90):.3f}")
    print(f"  torque sat     mean {out['tau_sat'][half:].mean():.2f} "
          f"(|tau|/limit)")
    print(f"  foot clearance (swing) p90 "
          f"{np.percentile(out['foot_z'][half:][~loaded], 90):.3f} m")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cmd_vx", nargs="?", type=float, default=1.0)
    ap.add_argument("--ckpt", default=REF_CKPT,
                    help="the reference's checkpoint (sim2sim_cuda.REF_CKPT)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    out = run(args.cmd_vx, args.ckpt, args.device)
    summarize(out, args.cmd_vx, N)
    return out


if __name__ == "__main__":
    main()
