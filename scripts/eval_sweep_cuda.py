"""Domain-randomization evaluation sweep of the PyTorch/CUDA port (the
port of scripts/eval_sweep.py, same flags plus ``--device``): run a
trained policy under each named DR preset and report the eval metric
registry (reference eval_metrics usage: DR_SETTINGS x METRICS_FNS,
mini_gym_learn/eval_metrics/{metrics,domain_randomization}.py).

    python scripts/eval_sweep_cuda.py [--logdir runs/r4_flagship_4000]
        [--num-envs 256] [--steps 250] [--presets static_low ...]
        [--device cuda|cpu]

Each preset builds the run's env with the preset's DR, no noise and a
3 x 3-cell terrain with a 5 m border, rolls the student policy for
``--steps`` steps from one initial state, and evaluates every metric probe
on the final state; ``done_rate`` is the share of env steps that ended an
episode. The results go to ``eval_sweep_cuda.json`` beside the run (the
JAX script's ``eval_sweep.json`` is left as it is). The physics runs as
the CUDA kernel on the card (``--device cuda``, the default; the script
raises when no card is visible) or as its plain PyTorch version on the
CPU (``--device cpu``).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

OUT_NAME = "eval_sweep_cuda.json"


def evaluate(logdir, preset_name, preset_fn, num_envs, steps,
             device="cuda"):
    """The metric registry of one preset: a dict of floats (per-dimension
    lists for the per-env probes, one key per reward term for
    ``auxiliary_rewards``) and ``done_rate``."""
    import torch
    from play_cuda import check_device, load_policy, run_cfg
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.learn.metrics import METRICS_FNS
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler

    cfg, blob = run_cfg(logdir)
    cfg = preset_fn(cfg)
    cfg.env.num_envs = num_envs
    cfg.noise.add_noise = False
    cfg.terrain.num_rows = 3
    cfg.terrain.num_cols = 3
    cfg.terrain.border_size = 5.0

    env = LeggedRobotEnv(cfg, device=check_device(device))
    ac = load_policy(logdir, env, blob)
    sampler = Sampler(0, env.device)
    state = env.initial_state(sampler)

    dones = torch.zeros((), device=env.device)
    with torch.no_grad():
        for _ in range(steps):
            actions = ac.act_student(state.obs, state.obs_history)
            state, res = env.step(state, actions, sampler)
            dones += res.done.sum()

    out = {"done_rate": dones.item() / (steps * num_envs)}
    for name, fn in METRICS_FNS.items():
        v = fn(env, state, ac, None)
        if isinstance(v, dict):
            # auxiliary_rewards: one scalar per active reward term
            for k, t in v.items():
                out[f"{name}/{k}"] = float(torch.mean(t))
        elif v.dim() > 0:
            # privileged_obs / latents: per-dimension mean over envs
            out[name] = torch.mean(v, dim=0).cpu().tolist()
        else:
            out[name] = float(v)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--num-envs", type=int, default=256)
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--presets", nargs="*", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from play_cuda import latest_run
    from rapid_locomotion_rl_tpu_torch.learn.dr_eval import DR_SETTINGS
    logdir = args.logdir or latest_run()
    print(f"evaluating {logdir}")
    names = args.presets or list(DR_SETTINGS)
    results = {}
    for name in names:
        results[name] = evaluate(logdir, name, DR_SETTINGS[name],
                                 args.num_envs, args.steps, args.device)
        row = results[name]
        print(f"{name:16s} done%={row['done_rate']*100:5.2f} "
              f"vel_rmsd={row['lin_vel_rmsd']:.3f} "
              f"CoT={row['cost_of_transport']:.2f} "
              f"height={row['base_height']:.3f}", flush=True)
    out = os.path.join(logdir, OUT_NAME)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"-> {out}")
    return results


if __name__ == "__main__":
    main()
