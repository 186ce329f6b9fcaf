"""Rollout-phase profiler of the PyTorch/CUDA port (the port of
scripts/profile_rollout.py, same flags plus ``--device``): splits the
flagship rollout into its phases by timing ablated variants.

  full       : rollout + GAE exactly as the Runner's iteration
  envstep    : 24 steps of env.step alone (zero actions, no policy,
               storage or GAE)
  env_nocurr : the same with the command curriculum off
  env_plane  : the same on the plane (curriculum on)
  physics    : 24 x decimation of ONLY the PD torques + physics call (no
               obs/reward/reset epilogue)
  policy     : 24 act paths of the actor-critic (distribution, value,
               a sampled action) on fixed obs

Derived attribution:
  physics kernel        = physics
  curriculum/resample   = envstep - env_nocurr
  trimesh-vs-plane      = envstep - env_plane
  obs/reward/epilogue   = env_nocurr - physics
  policy forward        = policy
  storage/GAE/rest      = full - envstep - policy

    python scripts/profile_rollout_cuda.py [--num-envs 4000] [--iters 10]
        [--mode ablate|trace] [--trace-dir build/torch-trace] [--plane]
        [--device cuda|cpu]

Each arm runs once untimed, then ``iters`` times between two card
synchronizations; each run starts from the same state. ``--mode trace``
writes a torch.profiler Chrome trace of three rollouts instead. The
physics runs as the CUDA kernel on the card (``--device cuda``, the
default; the script raises when no card is visible) or as its plain
PyTorch version on the CPU (``--device cpu``).
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

T = 24


def mc_cfg(num_envs, plane=False, curriculum=True):
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    cfg = config_mini_cheetah()
    cfg.env.num_envs = num_envs
    if plane:
        cfg.terrain.mesh_type = "plane"
        cfg.terrain.teleport_robots = False
    cfg.commands.command_curriculum = curriculum
    return cfg


def build(num_envs, device, plane=False):
    """The flagship env, a fresh policy of the default ACArgs, its env
    state and the rollout + GAE of the Runner's iteration."""
    import torch
    from play_cuda import check_device
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.learn.ppo import (PPOArgs,
                                                         compute_gae,
                                                         rollout)
    from rapid_locomotion_rl_tpu_torch.models.networks import (ACArgs,
                                                               ActorCritic)
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    dev = check_device(device)
    env = LeggedRobotEnv(mc_cfg(num_envs, plane), device=dev)
    torch.manual_seed(0)
    ac = ActorCritic(env.num_obs, env.num_privileged_obs,
                     env.num_obs_history, env.num_actions,
                     ACArgs()).to(dev).requires_grad_(False)
    env_state = env.initial_state(Sampler(0, dev))
    args = PPOArgs()

    @torch.no_grad()
    def rollout_gae(state):
        state, traj, infos = rollout(env, ac, args, state,
                                     Sampler(1, dev), T)
        last = ac.evaluate(state.obs, state.privileged_obs)
        return compute_gae(traj, last, args.gamma, args.lam)
    return env, ac, env_state, rollout_gae


def timeit(fn, args, n, label, log, dev):
    import torch
    fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    for _ in range(n):
        fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = (time.time() - t0) / n * 1e3
    log(f"[profile] {label:10s} {ms:8.1f} ms")
    return ms


def envstep_scan(env, zero):
    """24 env steps under ``zero`` from a state, with a fresh Sampler(0)."""
    import torch
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler

    @torch.no_grad()
    def scan(state):
        sampler = Sampler(0, env.device)
        for _ in range(T):
            state, res = env.step(state, zero, sampler)
        return res.rew
    return scan


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=4000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mode", default="ablate", choices=["ablate", "trace"])
    ap.add_argument("--trace-dir", default="build/torch-trace")
    ap.add_argument("--plane", action="store_true",
                    help="plane terrain (a quick run; the flagship is "
                         "trimesh)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns {arm: ms} and the derived attribution {name: ms}."""
    import torch
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import \
        LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    args = parse_args(argv)
    log = lambda s: print(s, flush=True)  # noqa: E731
    env, ac, env_state, rollout_gae = build(args.num_envs, args.device,
                                            plane=args.plane)
    dev = env.device

    if args.mode == "trace":
        from rapid_locomotion_rl_tpu_torch.utils.debug import \
            trace_iterations
        trace_iterations(rollout_gae, (env_state,), 3, logdir=args.trace_dir)
        return None

    ms = {}
    ms["full"] = timeit(rollout_gae, (env_state,), args.iters, "full", log,
                        dev)
    zero = torch.zeros((env.num_envs, env.num_actions), device=dev)
    ms["envstep"] = timeit(envstep_scan(env, zero), (env_state,), args.iters,
                           "envstep", log, dev)
    # the command curriculum off: its per-step cost
    env_nc = LeggedRobotEnv(mc_cfg(args.num_envs, args.plane, False),
                            device=dev)
    ms["env_nocurr"] = timeit(envstep_scan(env_nc, zero),
                              (env_nc.initial_state(Sampler(2, dev)),),
                              args.iters, "env_nocurr", log, dev)
    # the plane (curriculum on): the trimesh's cost
    env_pl = LeggedRobotEnv(mc_cfg(args.num_envs, True), device=dev)
    ms["env_plane"] = timeit(envstep_scan(env_pl, zero),
                             (env_pl.initial_state(Sampler(3, dev)),),
                             args.iters, "env_plane", log, dev)

    # bare physics: PD + physics call x decimation, no epilogue
    dr = env_state.dr
    decim = env.cfg.control.decimation

    @torch.no_grad()
    def physics_scan(sim):
        for _ in range(T):
            pp, imp, window = env.physics_inputs(env_state._replace(sim=sim))
            for _ in range(decim):
                torques, _t = env._compute_torques(
                    zero, sim, dr, last_dof_vel=env_state.last_dof_vel)
                sim = env._phys(sim, torques, pp, imp, window,
                                env_state.env_origins).state
        return sim
    ms["physics"] = timeit(physics_scan, (env_state.sim,), args.iters,
                           "physics", log, dev)

    # policy forward on fixed obs
    @torch.no_grad()
    def policy_scan(obs, priv):
        sampler = Sampler(1, dev)
        for _ in range(T):
            mean, std = ac.distribution(obs, priv)
            value = ac.evaluate(obs, priv)
            a = mean + std * sampler.normal("action", tuple(mean.shape))
        return a, value
    ms["policy"] = timeit(policy_scan, (env_state.obs,
                                        env_state.privileged_obs),
                          args.iters, "policy", log, dev)

    full = ms["full"]
    parts = {
        "physics kernel": ms["physics"],
        "curriculum/resample": ms["envstep"] - ms["env_nocurr"],
        "trimesh-vs-plane": ms["envstep"] - ms["env_plane"],
        "obs/reward epilogue": ms["env_nocurr"] - ms["physics"],
        "policy forward": ms["policy"],
        "storage/GAE/rest": full - ms["envstep"] - ms["policy"],
    }
    log("")
    log(f"[profile] === attribution at {args.num_envs} envs x {T} steps ===")
    for name, v in parts.items():
        log(f"[profile] {name:19s} {v:8.1f} ms ({v / full * 100:4.1f}%)")
    log(f"[profile] full rollout+GAE    {full:8.1f} ms")
    return ms, parts


if __name__ == "__main__":
    main()
