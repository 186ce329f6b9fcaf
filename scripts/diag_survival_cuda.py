"""Early-episode survival forensics on the PyTorch/CUDA port (the port of
scripts/diag_survival.py, same flags plus ``--device``).

Measures, under the flagship training config with an untrained-policy
action distribution (zero-mean Gaussian, std=1.0, what PPO produces at
iteration 0):
  - episode-length distribution at termination,
  - termination cause breakdown: timeout / contact (per report body) /
    terminal body height,
  - the same for zero actions (a sanity floor: standing must survive).

    python scripts/diag_survival_cuda.py [--envs 256] [--steps 400]
        [--flat] [--no-dr] [--device cuda|cpu]

The physics runs as the CUDA kernel on the card (``--device cuda``, the
default; the script raises when no card is visible) or as its plain
PyTorch version on the CPU (``--device cpu``).
"""

import argparse
import collections
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402

from tune_trot_cuda import DR_FLAGS  # noqa: E402


def build_env(num_envs: int, flat: bool, no_dr: bool, device="cuda"):
    from play_cuda import check_device
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    c = config_mini_cheetah()
    c.env.num_envs = num_envs
    if flat:
        c.terrain.mesh_type = "plane"
        c.terrain.teleport_robots = False
    if no_dr:
        c.noise.add_noise = False
        c.domain_rand.push_robots = False
        for f in DR_FLAGS:
            setattr(c.domain_rand, f, False)
    return LeggedRobotEnv(c, device=check_device(device)), c


def run(env, steps: int, action_std: float, seed: int = 0, state=None):
    """``steps`` env steps under actions ``action_std`` * N(0, 1) from
    ``state`` (default: the env's initial state from Sampler(seed)); the
    env draws from Sampler(seed), the actions from Sampler(seed + 1), as
    the JAX script splits PRNGKey(seed) and PRNGKey(seed + 1). Returns
    a dict of [steps, N] NumPy arrays (done, timeout, ep_len, term_body
    [steps, N, nterm], base_z, height_term) and the end state."""
    import torch
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    sampler = Sampler(seed, env.device)
    act = Sampler(seed + 1, env.device)
    if state is None:
        state = env.initial_state(sampler)
    term_idx = list(env.termination_contact_indices)
    rw = env.cfg.rewards
    outs = collections.defaultdict(list)
    with torch.no_grad():
        for _ in range(steps):
            a = action_std * act.normal("actions",
                                        (env.num_envs, env.num_actions))
            ep_len_before = state.episode_length
            state, res = env.step(state, a, sampler)
            term_f = torch.linalg.norm(state.contact_report[:, term_idx, :],
                                       dim=-1)          # [N, nterm]
            outs["done"].append(res.done)
            outs["timeout"].append(state.time_out_buf)
            outs["ep_len"].append(ep_len_before + 1)
            outs["term_body"].append(term_f > 1.0)
            outs["base_z"].append(state.sim.base_pos[:, 2])
            outs["height_term"].append(
                torch.mean(state.sim.base_pos[:, 2:3]
                           - state.measured_heights, dim=-1)
                < rw.terminal_body_height
                if rw.use_terminal_body_height
                else torch.zeros_like(res.done))
    return {k: torch.stack(v).cpu().numpy() for k, v in outs.items()}, state


def summarize(env, outs, label):
    done = outs["done"]
    timeout = outs["timeout"]
    ep_len = outs["ep_len"]
    term_body = outs["term_body"]
    height_term = outs["height_term"]

    deaths = done & ~timeout
    lens = ep_len[done]
    if lens.size == 0:
        print(f"[{label}] no episode ended in {done.shape[0]} steps "
              f"(all surviving)")
        return
    print(f"\n[{label}] {int(done.sum())} episode ends over "
          f"{done.shape[0]} steps x {done.shape[1]} envs")
    print(f"  ep_len at end:   median {np.median(lens):6.0f}  "
          f"mean {lens.mean():6.1f}  p10 {np.percentile(lens, 10):5.0f}  "
          f"p90 {np.percentile(lens, 90):6.0f}")
    print(f"  cause: timeout {int((done & timeout).sum())}, "
          f"contact-term {int(deaths.sum())}, "
          f"height-term {int((deaths & height_term).sum())} (subset)")
    names = [env.model.report_body_names[i]
             for i in env.termination_contact_indices]
    counts = collections.Counter()
    tb = term_body[deaths]           # [n_deaths, nterm]
    for j, n in enumerate(names):
        counts[n] = int(tb[:, j].sum())
    top = counts.most_common(12)
    print("  termination bodies (contact > 1N at death):")
    for n, c in top:
        if c:
            print(f"    {n:18s} {c}")
    dlens = ep_len[deaths]
    if dlens.size:
        print(f"  death ep_len:    median {np.median(dlens):6.0f}  "
              f"mean {dlens.mean():6.1f}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--flat", action="store_true")
    ap.add_argument("--no-dr", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns the env and each arm's outputs, by label."""
    args = parse_args(argv)
    env, cfg = build_env(args.envs, args.flat, args.no_dr, args.device)
    print(f"config: mesh={cfg.terrain.mesh_type} dr={not args.no_dr} "
          f"envs={args.envs} steps={args.steps} "
          f"dof_init_range={cfg.init_state.dof_init_range} "
          f"randomize_root_vel={cfg.init_state.randomize_root_vel}")
    arms = {}
    for label, std, seed in (("zero actions", 0.0, 0),
                             ("random policy std=1.0", 1.0, 7)):
        arms[label], _ = run(env, args.steps, action_std=std, seed=seed)
        summarize(env, arms[label], label)
    return env, arms


if __name__ == "__main__":
    main()
