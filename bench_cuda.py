#!/usr/bin/env python3
"""Throughput benchmark of the PyTorch/CUDA port: full PPO training
iterations at the reference's flagship configuration (Mini Cheetah, 4000
envs, 24 steps/env/iter, 5x4 minibatch PPO — BASELINE.md), on one GPU.
The twin of bench.py, to its contract, on the port's code.

    python3 bench_cuda.py [--device cuda|cpu]

Prints ONE JSON line on stdout:
  {"metric": "env_steps_per_sec", "value": N, "unit": "env-steps/s",
   "vs_baseline": N / 50000}
Everything else goes to stderr: the card's name and power limit, and for
each size its rollout/update split, the timed iterations' ms (min, median,
max), peak device memory, K1 launches per iteration and the terrain
lookup kernel's beside them, and whether the K1 library was built in this
run or loaded from build/torch_kernels/<hash>/;
then the comparison arm on the general (AoS) step, which runs no K1.

Environment, as bench.py reads it: BENCH_SIZES (env counts, default
4000,1024,8192), BENCH_BUDGET_S (default 1500) and BENCH_PALLAS ("0" skips
the comparison arm without the hand kernel).

It runs on the card unless ``--device cpu`` is given (the plain physics;
the tests use it). Without a card and without ``--device cpu`` it exits 3
and prints no JSON line.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

_T_START = time.time()
CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


def _bench_size(num_envs, steps_per_env, n_iter=20, log=lambda s: None,
                physics_impl=None, device="cuda", stats=None):
    """Env-steps/s of ``n_iter`` flagship training iterations at
    ``num_envs`` after 2 warm-up ones, from a fresh policy and env state.
    ``stats`` (a dict), when given, receives the env, its end state and
    the figures logged."""
    import torch
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.learn.ppo import (PPOArgs,
                                                         init_ppo_state,
                                                         make_train_functions)
    from rapid_locomotion_rl_tpu_torch.models.networks import (ACArgs,
                                                               ActorCritic)
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    t_size = time.time()
    cfg = config_mini_cheetah()
    cfg.env.num_envs = num_envs
    if physics_impl is not None:
        cfg.sim.physics_impl = physics_impl
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    env = LeggedRobotEnv(cfg, device=dev)
    # explicit seeds in place of bench.py's k1 (policy), k2 (env state)
    # and k3 (the iterations' draws)
    torch.manual_seed(0)
    ac = ActorCritic(env.num_obs, env.num_privileged_obs,
                     env.num_obs_history, env.num_actions,
                     ACArgs()).to(dev)
    ppo_args = PPOArgs()
    ppo_state = init_ppo_state(ac, ppo_args)
    env_state = env.initial_state(Sampler(0, dev))
    sampler = Sampler(1, dev)
    rollout_gae, update = make_train_functions(env, ac, ppo_args,
                                               steps_per_env)

    def one_iter(env_state, ppo_state):
        env_state, traj, adv, ret, _ = rollout_gae(env_state, sampler)
        ppo_state, metrics = update(ppo_state, traj, adv, ret, sampler)
        return env_state, ppo_state, traj, adv, ret, metrics

    # warm-up: two iterations. The K1 library (one nvcc, 5-13 s) builds at
    # the first physics call when build/torch_kernels/<hash>/ lacks it, so
    # the warm-up absorbs the build as bench.py's absorbs the compile.
    bound_before = set(CP.KERNEL.builds)
    t_warm = time.time()
    for _ in range(2):
        env_state, ppo_state, traj, adv, ret, metrics = one_iter(
            env_state, ppo_state)
    sync()
    dt_warm = time.time() - t_warm

    # the timed block, synchronised after each iteration for its spread
    # (each update already waits for the device at every minibatch's KL)
    CP.KERNEL.zero_counts()
    iter_s = []
    for _ in range(n_iter):
        t0 = time.time()
        env_state, ppo_state, traj, adv, ret, metrics = one_iter(
            env_state, ppo_state)
        sync()
        iter_s.append(time.time() - t0)
    dt_total = sum(iter_s) / n_iter
    launched = dict(CP.KERNEL.variant_launches)
    lookups_per_iter = CP.KERNEL.geom_terrain_launches / n_iter

    # phase split, timed separately: 5 rollouts from one env state (the
    # env step changes no tensor in place), then 5 updates of one
    # trajectory. The updates move ``ac`` and the optimizers on, as
    # bench.py's do not; nothing after the split reads them.
    t0 = time.time()
    for _ in range(5):
        rollout_gae(env_state, Sampler(2, dev))
    sync()
    dt_roll = (time.time() - t0) / 5
    t0 = time.time()
    for _ in range(5):
        update(ppo_state, traj, adv, ret, Sampler(3, dev))
    sync()
    dt_upd = (time.time() - t0) / 5

    steps = num_envs * steps_per_env
    log(f"[bench] {num_envs} envs: {steps / dt_total:,.0f} env-steps/s "
        f"(iter {dt_total * 1e3:.1f} ms = rollout {dt_roll * 1e3:.1f} "
        f"+ update {dt_upd * 1e3:.1f} ms)")
    ms = sorted(t * 1e3 for t in iter_s)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    k1_per_iter = {CP.variant_name(v): n / n_iter
                   for v, n in sorted(launched.items())}
    if not launched:
        k1 = "K1 launches per iteration: none"
    else:
        origin = []
        for v in sorted(launched):
            if v in bound_before:
                where = "loaded earlier in this process"
            elif CP.KERNEL.builds[v][2] > 0:
                where = (f"built in this run ({CP.KERNEL.builds[v][2]:.1f} s "
                         f"of nvcc)")
            else:
                where = (f"loaded from build/torch_kernels/"
                         f"{CP.sources_hash()}/")
            origin.append(f"{CP.variant_name(v)} {where}")
        k1 = ("K1 launches per iteration: " + ", ".join(
            f"{name} {n:g}" for name, n in k1_per_iter.items())
            + f", terrain lookup (geom_terrain) {lookups_per_iter:g}"
            + "; library " + ", ".join(origin))
    log(f"[bench] {num_envs} envs: warm-up {dt_warm:.1f}s; {n_iter} timed "
        f"iterations ms min {ms[0]:.1f} / median {statistics.median(ms):.1f}"
        f" / max {ms[-1]:.1f}; peak device memory "
        + ("not measured (CPU)" if peak is None
           else f"{peak / 2**20:.1f} MiB") + f"; {k1}; the size took "
        f"{time.time() - t_size:.1f}s in all")
    if stats is not None:
        stats.update(env=env, env_state=env_state, iter_ms=ms,
                     rollout_ms=dt_roll * 1e3, update_ms=dt_upd * 1e3,
                     warmup_s=dt_warm, peak_bytes=peak,
                     k1_per_iter=k1_per_iter,
                     lookups_per_iter=lookups_per_iter)
    return steps / dt_total


def _probe(q):
    import torch
    if not torch.cuda.is_available():
        return
    dev = torch.device("cuda", 0)
    x = torch.ones((4, 4), device=dev)
    (x @ x).sum().item()
    q.put(torch.cuda.get_device_name(0))


def _preflight(log, timeout_s=180):
    """Fail fast with a clear message when no card answers: a spawned
    process must make a 4x4 product on cuda:0 within ``timeout_s``. Then
    the card's name and power limit go to stderr."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_probe, args=(q,))
    p.start()
    p.join(timeout_s)
    if p.is_alive():
        p.kill()
        p.join()
        log(f"[bench] no answer from cuda:0 within {timeout_s}s — aborting "
            "instead of hanging.")
        sys.exit(3)
    try:
        name = q.get(timeout=5)
    except queue.Empty:
        log(f"[bench] no CUDA card (the probe exited with {p.exitcode}); "
            "pass --device cpu to run the plain physics on the CPU.")
        sys.exit(3)
    card = subprocess.run(CARD_QUERY, capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    log(f"[bench] device: {name} | {card}")


def _emit(flagship):
    # BASELINE.md's north-star: IsaacGym's ~45-50k env-steps/s on one GPU,
    # the reference's figure (not one of this card or of a TPU)
    baseline = 50_000.0
    print(json.dumps({
        "metric": "env_steps_per_sec",
        "value": round(flagship),
        "unit": "env-steps/s",
        "vs_baseline": round(flagship / baseline, 3),
    }), flush=True)


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (K1 on the card) or cpu (its plain version)")
    device = ap.parse_args(argv).device
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    on_card = torch.device(device).type == "cuda"
    if on_card:
        _preflight(log)
    else:
        log(f"[bench] device: {device} (the plain physics; not a card's "
            "figure)")
    # the flagship size first, and the JSON line the moment it exists
    sizes = tuple(int(s) for s in
                  os.environ.get("BENCH_SIZES", "4000,1024,8192").split(","))
    budget_s = float(os.environ.get("BENCH_BUDGET_S", "1500"))
    # start a size or the arm only if it can finish inside the budget: the
    # dearest, the AoS arm, took 370.9 s and a K1 size 133-150 s on an
    # NVIDIA H100 80GB HBM3 at 700 W (PERF.md §5, the default sizes)
    arm_cost_s = 400.0
    sweep = {}
    emitted = False
    for n in sizes:
        if emitted and time.time() - _T_START > budget_s - arm_cost_s:
            log(f"[bench] budget {budget_s:.0f}s nearly exhausted "
                f"({time.time() - _T_START:.0f}s elapsed) — skipping "
                f"{n}-env size (headline already emitted)")
            continue
        try:
            sweep[n] = _bench_size(n, 24, log=log, device=device)
        except torch.cuda.OutOfMemoryError as e:
            log(f"[bench] {n} envs out of device memory: {e}")
            torch.cuda.empty_cache()
            continue
        if n == 4000:
            _emit(sweep[n])
            emitted = True
    if not emitted:
        if not sweep:
            log("[bench] every size failed")
            return 4
        # the 4000-env size failed but another worked: report the largest
        n = max(sweep)
        log(f"[bench] 4000-env size unavailable; reporting {n}-env figure")
        _emit(sweep[n])
    # the comparison arm without the hand kernel: the general (AoS) step,
    # plain PyTorch, what --physics-impl aos trains on (the plain twin of
    # K1 repeats its arithmetic step by step, 0.4-1.9 s a call: no yardstick)
    if on_card and os.environ.get("BENCH_PALLAS", "1") != "0":
        if time.time() - _T_START > budget_s - arm_cost_s:
            log("[bench] budget exhausted — skipping the aos comparison arm")
        else:
            try:
                v = _bench_size(4000, 24, log=log, physics_impl="aos",
                                device=device)
                log(f"[bench] aos (plain PyTorch, no K1): {v:,.0f} "
                    "env-steps/s")
            except torch.cuda.OutOfMemoryError as e:
                log(f"[bench] aos arm out of device memory: {e}")
    log(f"[bench] total wall time {time.time() - _T_START:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
