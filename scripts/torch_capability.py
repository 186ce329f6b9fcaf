#!/usr/bin/env python3
"""The locomotion-capability gate on the PyTorch/CUDA port: the physics
must let a robot travel (the port of tests/test_locomotion_capability.py's
three gates, at their sizes and thresholds).

    python scripts/torch_capability.py [--device cuda|cpu]

1. trot:     an open-loop diagonal trot (scripts/tune_trot_cuda.py,
             freq 2.0, thigh 0.8, calf 1.0, lead 0.5) on 4 envs moves
             >= 0.6 m in 300 steps (6 s), with no done and a final base
             height in (0.15, 0.45) m.
2. flagship: the newest flagship policy present (``CKPT_R3``), teacher
             path, 8 envs under a pinned command vx = 1.0 for 300 steps:
             median net forward displacement >= 3.6 m.
3. walks:    runs/ab7_ent0_fixedphys2's policy, 8 envs under the pinned
             command (-1.5, 0, 2.5): the mean planar speed of steps
             100-300 of the 4 fastest envs > 0.5 m/s, the state finite.

Each gate raises AssertionError when it fails; the script exits 1 then.
These gates caught two physics regressions that every numeric unit test
missed (the JAX test's docstring). The physics runs as the CUDA kernel on
the card (``--device cuda``, the default; the script raises when no card
is visible) or as its plain PyTorch version on the CPU (``--device
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

from tune_trot_cuda import flat_no_dr  # noqa: E402

CKPT = os.path.join(ROOT, "runs", "ab7_ent0_fixedphys2", "checkpoints",
                    "ac_weights_last.pkl")
# the newest flagship trained on the current physics that is present
# (tests/test_locomotion_capability.py:30-36)
_FLAGSHIPS = tuple(os.path.join(ROOT, "runs", r, "checkpoints",
                                "ac_weights_last.pkl")
                   for r in ("r5_warmup", "r4_flagship_4000", "r3_flagship"))
CKPT_R3 = next((p for p in _FLAGSHIPS if os.path.exists(p)), _FLAGSHIPS[-1])

STEPS = 300
# the JAX gates' thresholds (tests/test_locomotion_capability.py)
TROT = dict(freq=2.0, a_thigh=0.8, a_calf=1.0, lead=0.5)   # :75
TROT_MIN_DX = 0.6                   # :77
TROT_Z = (0.15, 0.45)               # :78
FLAGSHIP_MIN_MEDIAN_DX = 3.6        # :110
WALK_MIN_TOP4_SPEED = 0.5           # :162


def clean_cfg(num_envs=8, long_episodes=True):
    """The gate's config (tests/test_locomotion_capability.py:39-56):
    config_mini_cheetah on flat ground, no DR, the default pose at rest,
    100 s episodes (gate 3 keeps the default 20 s: ``long_episodes``
    off)."""
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    c = flat_no_dr(config_mini_cheetah(), num_envs)
    c.init_state.dof_init_range = [1.0, 1.0]
    c.init_state.randomize_root_vel = False
    if long_episodes:
        c.env.episode_length_s = 100.0
    return c


def _env(cfg, device):
    from play_cuda import check_device
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    return LeggedRobotEnv(cfg, device=check_device(device))


def load_teacher(env, path):
    """An ActorCritic of the default ACArgs with a JAX ``ac_weights`` file's
    params, on the env's device, frozen."""
    from rapid_locomotion_rl_tpu_torch.convert import params_from_flax
    from rapid_locomotion_rl_tpu_torch.models.networks import (ACArgs,
                                                               ActorCritic)
    from rapid_locomotion_rl_tpu_torch.utils.checkpoint import load_pytree
    ac = ActorCritic(env.num_obs, env.num_privileged_obs,
                     env.num_obs_history, env.num_actions, ACArgs())
    ac.load_state_dict(params_from_flax(load_pytree(path)["params"]))
    return ac.to(env.device).requires_grad_(False)


def pinned(state, cmd):
    """The state with commands[:, :3] set to ``cmd``."""
    import torch
    c = state.commands.clone()
    c[:, :3] = torch.tensor(cmd, dtype=c.dtype, device=c.device)
    return state._replace(commands=c)


def gate_trot(device="cuda"):
    """Gate 1 (:59-78): the scripted trot. Returns dx, dones and z."""
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    from tune_trot_cuda import make_runner, run_trot
    env = _env(clean_cfg(4), device)
    state0 = env.initial_state(Sampler(0, env.device))
    dx, dones, z = run_trot(env, make_runner(env, steps=STEPS), state0,
                            **TROT)
    print(f"trot: dx {dx:+.3f} m, dones {dones:.0f}, final z {z:.3f} m",
          flush=True)
    assert dones == 0, "trot must not trigger terminations"
    assert abs(dx) >= TROT_MIN_DX, f"trot travelled only {dx:+.3f} m"
    assert TROT_Z[0] < z < TROT_Z[1], f"unphysical final height {z:.3f}"
    return dict(dx=dx, dones=dones, z=z)


def _teacher_rollout(env, ac, state, cmd, steps, sampler):
    """``steps`` env steps under the teacher's mean action with the
    command pinned after each step (resets zero it); returns the end state
    and the planar base speed [steps, N] after each step."""
    import torch
    speed = []
    state = pinned(state, cmd)
    with torch.no_grad():
        for _ in range(steps):
            a = ac.act_teacher(state.obs, state.privileged_obs)
            state, _ = env.step(state, a, sampler)
            state = pinned(state, cmd)
            speed.append(torch.linalg.norm(state.sim.base_lin_vel[:, :2],
                                           dim=-1))
    return state, torch.stack(speed)


def gate_flagship(device="cuda"):
    """Gate 2 (:81-110): the flagship tracks +vx. Returns the per-env dx,
    its median, the env and its end state."""
    import numpy as np
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    env = _env(clean_cfg(8), device)
    ac = load_teacher(env, CKPT_R3)
    sampler = Sampler(0, env.device)
    state = env.initial_state(sampler)
    x0 = state.sim.base_pos[:, 0]
    state, _ = _teacher_rollout(env, ac, state, (1.0, 0.0, 0.0), STEPS,
                                sampler)
    dx = (state.sim.base_pos[:, 0] - x0).cpu().numpy()
    med = float(np.median(dx))
    print(f"flagship {os.path.relpath(CKPT_R3, ROOT)}: median dx {med:.3f} "
          f"m over {STEPS} steps at vx 1.0 (per env {np.round(dx, 3)})",
          flush=True)
    # cmd vx=1.0 for 6 s => 6 m perfect; demand >=60% net forward on median
    assert med >= FLAGSHIP_MIN_MEDIAN_DX, dx
    return dict(dx=dx, median=med, env=env, state=state)


def gate_walks(device="cuda"):
    """Gate 3 (:113-162): the ab7 policy sustains speed. Returns the
    per-env mean speed of steps 100-300, the top-4 mean, the env and its
    end state."""
    import numpy as np
    import torch
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    env = _env(clean_cfg(8, long_episodes=False), device)
    ac = load_teacher(env, CKPT)
    sampler = Sampler(0, env.device)
    state = env.initial_state(sampler)
    # a command from the policy's trained (curriculum-expanded) region
    state, speed = _teacher_rollout(env, ac, state, (-1.5, 0.0, 2.5), STEPS,
                                    sampler)
    assert bool(torch.isfinite(state.sim.q).all()), "non-finite joint state"
    per_env = speed[100:].mean(0).cpu().numpy()
    top4 = float(np.sort(per_env)[-4:].mean())
    print(f"walks {os.path.relpath(CKPT, ROOT)}: top-4 mean speed {top4:.3f}"
          f" m/s over steps 100-{STEPS} (per env {np.round(per_env, 3)})",
          flush=True)
    assert top4 > WALK_MIN_TOP4_SPEED, per_env
    return dict(per_env=per_env, top4=top4, env=env, state=state)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    failed = []
    for gate in (gate_trot, gate_flagship, gate_walks):
        try:
            gate(args.device)
            print(f"{gate.__name__}: passed", flush=True)
        except AssertionError as e:
            print(f"{gate.__name__}: FAILED {e}", flush=True)
            failed.append(gate.__name__)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
