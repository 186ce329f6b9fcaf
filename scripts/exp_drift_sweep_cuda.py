"""Full trot-parameter sweep per physics arm, batched over the env axis, on
the PyTorch/CUDA port (the port of scripts/exp_drift_sweep.py, plus
``--device``).

For each candidate physics config, every (freq, a_thigh, a_calf, lead)
combination, NEGATIVE thigh amplitudes (reverse gaits) included, runs as
its own env of one rollout. Reports the best forward and best backward
net displacement: the flagship physics should keep forward capability
while making reverse gaits pay (EXPERIMENTS.md §14).

    python scripts/exp_drift_sweep_cuda.py [--device cuda|cpu]

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

import numpy as np  # noqa: E402

from tune_trot_cuda import flat_no_dr, make_runner  # noqa: E402

ARMS = (("legacy", 0.01), ("hull", 0.01), ("hull", 0.02), ("hull", 0.03))


def sweep_params() -> np.ndarray:
    pts = []
    for freq in (1.5, 2.0, 2.5):
        for ath in (-1.2, -0.8, -0.5, 0.5, 0.8, 1.2):
            for acf in (0.6, 1.0):
                for lead in (0.5, 1.2):
                    pts.append((freq, ath, acf, lead))
    return np.asarray(pts, np.float32)          # [P,4]


def build_env(fit: str, patch: float, num_envs: int, device="cuda"):
    from play_cuda import check_device
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    c = flat_no_dr(config_mini_cheetah(), num_envs)
    c.init_state.dof_init_range = [1.0, 1.0]
    c.init_state.randomize_root_vel = False
    c.env.episode_length_s = 100.0
    c.asset.mesh_sphere_fit = fit
    c.sim.torsional_patch_radius = patch
    return LeggedRobotEnv(c, device=check_device(device))


def run_arm(fit: str, patch: float, P: np.ndarray, steps=300, device="cuda"):
    """The sweep's points as the envs of one rollout under the arm's
    physics, each env's trot targets its own row of ``P``
    (tune_trot_cuda.trot_actions). Returns per-env dx, dones, final z and
    the alive mask."""
    import torch
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    env = build_env(fit, patch, P.shape[0], device)
    state0 = env.initial_state(Sampler(0, env.device))
    run = make_runner(env, steps=steps)
    dx, nd, z = run(state0, torch.tensor(P, device=env.device))
    dx, nd, z = (x.cpu().numpy() for x in (dx, nd, z))
    ok = (nd == 0) & (z > 0.1)                 # alive, not collapsed
    fwd = np.where(ok, dx, -np.inf)
    bwd = np.where(ok, dx, np.inf)
    i_f, i_b = int(np.argmax(fwd)), int(np.argmin(bwd))
    pt = lambda i: tuple(round(float(v), 3) for v in P[i])  # noqa: E731
    print(f"{fit:7s} r={patch:5.3f}  best_fwd {dx[i_f]:+.3f} m "
          f"@ {pt(i_f)}   best_bwd {dx[i_b]:+.3f} m @ {pt(i_b)}  "
          f"(alive {int(ok.sum())}/{len(ok)})", flush=True)
    return dx, nd, z, ok


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None):
    device = parse_args(argv).device
    P = sweep_params()
    print(f"{P.shape[0]} sweep points x 300 steps per arm")
    return {arm: run_arm(*arm, P, device=device) for arm in ARMS}


if __name__ == "__main__":
    main()
