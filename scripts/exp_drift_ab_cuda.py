"""Physics-config A/B for the flagship on the PyTorch/CUDA port (the port
of scripts/exp_drift_ab.py, plus ``--device``): does the calf hull
sphere-chain (AssetCfg.mesh_sphere_fit="hull") plus a wider torsional
patch make backward scuffing cost what it costs PhysX?

Runs matched FORWARD and BACKWARD open-loop trots under each candidate
config and reports net dx: the config is good when forward gaits keep (or
gain) displacement while backward gaits lose it (EXPERIMENTS.md §14).

    python scripts/exp_drift_ab_cuda.py [--device cuda|cpu]

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

from tune_trot_cuda import flat_no_dr, make_runner, run_trot  # noqa: E402


def build_env(fit: str, patch: float, device="cuda"):
    from play_cuda import check_device
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    c = flat_no_dr(config_mini_cheetah(), 4)
    c.env.episode_length_s = 100.0
    c.asset.mesh_sphere_fit = fit
    c.sim.torsional_patch_radius = patch
    return LeggedRobotEnv(c, device=check_device(device))


# (freq, a_thigh, a_calf, lead): forward trots of the sweep plus their
# mirrored (backward) counterparts: a negative thigh amplitude swings the
# legs the other way, producing the reverse gait RL exploits.
GAITS = {
    "fwd_slow": (1.5, 0.8, 1.0, 1.2),
    "fwd_fast": (2.5, 1.2, 1.0, 1.2),
    "bwd_slow": (1.5, -0.8, 1.0, 1.2),
    "bwd_fast": (2.5, -1.2, 1.0, 1.2),
    "shuffle": (2.0, 0.3, 0.3, 0.5),     # low clearance: scuffing regime
}
ARMS = [("legacy", 0.01),           # the flagship's physics
        ("legacy", 0.025),
        ("hull", 0.01),
        ("hull", 0.02),
        ("hull", 0.03)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns {(fit, patch): {gait: (dx, dones, z)}}."""
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    device = parse_args(argv).device
    print(f"{'arm':18s} " + " ".join(f"{g:>10s}" for g in GAITS)
          + "   (net dx [m] over 6 s; dones flagged *)")
    table = {}
    for fit, patch in ARMS:
        env = build_env(fit, patch, device)
        runner = make_runner(env, steps=300)      # 6 s at dt=0.02
        state0 = env.initial_state(Sampler(0, env.device))
        row, table[fit, patch] = [], {}
        for g, (freq, ath, acf, lead) in GAITS.items():
            dx, nd, z = run_trot(env, runner, state0, freq, ath, acf, lead)
            table[fit, patch][g] = (dx, nd, z)
            row.append(f"{dx:+9.3f}{'*' if nd else ' '}")
        print(f"{fit:7s} r={patch:5.3f}  " + " ".join(f"{v:>10s}" for v in row),
              flush=True)
    return table


if __name__ == "__main__":
    main()
