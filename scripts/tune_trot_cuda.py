"""Tune an open-loop scripted trot on the PyTorch/CUDA port (the port of
scripts/tune_trot.py, plus ``--device``; used by the locomotion-capability
gate, scripts/torch_capability.py).

Sweeps a small grid of (frequency, thigh amplitude, calf amplitude, phase
lead) over the real env on flat ground and reports net +x displacement:
the physics must let a hand-scripted diagonal trot travel forward, or RL
has no gait to find (EXPERIMENTS.md §8).

    python scripts/tune_trot_cuda.py [--device cuda|cpu]

The physics runs as the CUDA kernel on the card (``--device cuda``, the
default; the script raises when no card is visible) or as its plain
PyTorch version on the CPU (``--device cpu``).
"""

import argparse
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

DR_FLAGS = ("randomize_friction", "randomize_base_mass",
            "randomize_com_displacement", "randomize_motor_strength",
            "randomize_Kp_factor", "randomize_Kd_factor",
            "randomize_restitution")


def flat_no_dr(cfg, num_envs):
    """The research scripts' common cut of a config: ``num_envs`` envs on
    flat ground, no teleport, observation noise, pushes, domain
    randomization or command curriculum."""
    cfg.env.num_envs = num_envs
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.teleport_robots = False
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    for f in DR_FLAGS:
        setattr(cfg.domain_rand, f, False)
    cfg.commands.command_curriculum = False
    return cfg


def _sin(x):
    """float32 sine, taken in float64 and rounded once: the float32 sines
    of PyTorch and XLA each miss the correctly rounded value by an ulp on
    a few percent of inputs, on different inputs."""
    return x.double().sin().float()


def trot_actions(env, t, p):
    """Open-loop diagonal trot in ACTION space (P-control targets are
    default + 0.25 * action, hips x0.5). ``p`` = [..., 4] of (freq,
    a_thigh, a_calf, lead), one row per env or a single [4] for all;
    ``t`` a float32 scalar tensor. Returns [..., num_dof] in the JAX
    script's float32 order of operations (the sine within an ulp of
    XLA's)."""
    import torch
    freq, a_thigh, a_calf, lead = p.unbind(-1)
    phase = 2.0 * math.pi * freq * t
    jn = list(env.model.joint_names)
    a = torch.zeros(p.shape[:-1] + (env.num_dof,), device=p.device)
    # diagonal pairs: (FL, RR) at phase 0, (FR, RL) at pi
    for leg, ph in (("FL", 0.0), ("RR", 0.0), ("FR", math.pi),
                    ("RL", math.pi)):
        s = _sin(phase + ph)
        sw = _sin(phase + ph + lead)
        # thigh swings fore-aft; calf retracts (shortens) during swing
        a[..., jn.index(f"{leg}_thigh_joint")] = a_thigh * s
        a[..., jn.index(f"{leg}_calf_joint")] = -a_calf * torch.clamp(
            sw, min=0.0)
    return a


def step_time(env, i):
    """The control time of step ``i`` as the JAX scan computes it:
    float32(i) * dt, in float32."""
    import torch
    return torch.tensor(float(i), dtype=torch.float32,
                        device=env.device) * env.dt


def make_runner(env, steps=300):
    """``run(state, p)``: ``steps`` env steps under the trot of ``p`` ([4]
    for every env, or [N, 4]); returns (per-env net dx [N], the number of
    dones, and the final base heights [N]). Each call draws from a fresh
    Sampler(0), so a call depends on its inputs only, as a jitted JAX
    call does."""
    import torch
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler

    @torch.no_grad()
    def run(state, p):
        sampler = Sampler(0, env.device)
        x0 = state.sim.base_pos[:, 0]
        dones = torch.zeros(env.num_envs, dtype=torch.int32,
                            device=env.device)
        for i in range(steps):
            a = trot_actions(env, step_time(env, i), p)
            a = a.expand(env.num_envs, env.num_dof)
            state, res = env.step(state, a, sampler)
            dones = dones + res.done.to(torch.int32)
        return state.sim.base_pos[:, 0] - x0, dones, state.sim.base_pos[:, 2]
    return run


def run_trot(env, runner, state0, freq, a_thigh, a_calf, lead):
    """(mean net dx [m], total dones, mean final base height [m])."""
    import torch
    p = torch.tensor([freq, a_thigh, a_calf, lead], dtype=torch.float32,
                     device=env.device)
    dx, nd, z = runner(state0, p)
    return (float(dx.mean()), float(nd.sum()), float(z.mean()))


def build_env(device, num_envs=4):
    """tune_trot.py's env: config_mini_cheetah flat, no DR, 100 s
    episodes."""
    from play_cuda import check_device
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    c = flat_no_dr(config_mini_cheetah(), num_envs)
    c.env.episode_length_s = 100.0
    return LeggedRobotEnv(c, device=check_device(device))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None):
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    env = build_env(parse_args(argv).device)
    runner = make_runner(env)
    state0 = env.initial_state(Sampler(0, env.device))
    best = None
    for freq in (1.5, 2.0, 2.5):
        for a_thigh in (0.5, 0.8, 1.2):
            for a_calf in (0.6, 1.0):
                for lead in (0.5, 1.2):
                    dx, nd, z = run_trot(env, runner, state0,
                                         freq, a_thigh, a_calf, lead)
                    tag = f"f={freq} ath={a_thigh} acf={a_calf} lead={lead}"
                    print(f"{tag:42s} dx={dx:+.3f} m dones={nd:.0f} z={z:.3f}",
                          flush=True)
                    if nd == 0 and (best is None or dx > best[0]):
                        best = (dx, tag)
    print("\nBEST:", best)
    return best


if __name__ == "__main__":
    main()
