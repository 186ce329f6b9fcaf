"""One rank of the port's data-parallel tests, run as its own process:

    python tests/torch_dist_worker.py JOB RANK WORLD PORT OUT

JOB ``iteration``: one train_iteration of :func:`small_plane_cfg`'s env
with its env axis split over WORLD gloo ranks (WORLD 1: one process, no
process group); rank 0 saves the metrics, the parameters, the LR, the
curriculum and the env state gathered from every rank to OUT.
JOB ``curriculum``: :func:`curriculum_cases`' inputs split over the ranks,
gathered to global order as the env gathers them, then the curriculum's
update; rank 0 saves the new states to OUT.

Imports torch and the port only. :class:`Processes` starts such ranks (or
any commands) from a test."""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from rapid_locomotion_rl_tpu_torch.parallel import sharding as SH  # noqa: E402

WORKER = os.path.abspath(__file__)
TIMEOUT = 180     # seconds for each process of a test
N_ENVS = 16
N_STEPS = 4


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Processes:
    """Commands started together, each with its output to its log; the
    test that needs them waits (each within TIMEOUT), and any left are
    killed at the end of the module."""

    def __init__(self, cmds, logs, envs=None):
        self.logs = logs
        self.procs = []
        for i, (cmd, log) in enumerate(zip(cmds, logs)):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                    env=None if envs is None else envs[i]))

    def wait(self):
        """Fails with the logs' tails unless every command exits 0."""
        try:
            rcs = [p.wait(timeout=TIMEOUT) for p in self.procs]
        finally:
            self.kill()
        if any(rcs):
            tails = "\n====\n".join(open(log).read()[-2000:]
                                     for log in self.logs)
            raise AssertionError(f"exit codes {rcs}:\n{tails}")

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def small_plane_cfg(num_envs: int = N_ENVS):
    """config_mini_cheetah on the plane (tests/test_sharding.py's), with
    the command curriculum active within a 4-step iteration: commands
    resampled every 2 steps, both success thresholds at 0, and the last 4
    envs eval envs (they sit on the last rank)."""
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    cfg = config_mini_cheetah()
    cfg.env.num_envs = num_envs
    cfg.env.num_eval_envs = 4
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.teleport_robots = False
    cfg.commands.resampling_time = 2 * cfg.sim.dt * cfg.control.decimation
    cfg.commands.forward_curriculum_threshold = 0.0
    cfg.commands.yaw_curriculum_threshold = 0.0
    return cfg


def init(rank: int, world: int, port: int):
    if world > 1:
        torch.distributed.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world)
    return SH.make_mesh("cpu")


def run_iteration(mesh):
    """One iteration from a fresh state at seed 0; the results on rank 0
    (None elsewhere)."""
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.learn.ppo import (
        PPOArgs, init_ppo_state, train_iteration)
    from rapid_locomotion_rl_tpu_torch.models.networks import (ACArgs,
                                                               ActorCritic)
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    env = LeggedRobotEnv(small_plane_cfg(), device="cpu")
    torch.manual_seed(0)
    ac = ActorCritic(env.num_obs, env.num_privileged_obs,
                     env.num_obs_history, env.num_actions, ACArgs())
    ppo_args = PPOArgs()
    ppo_state = init_ppo_state(ac, ppo_args)
    sampler = Sampler(0, "cpu")
    state = env.initial_state(sampler)
    if mesh.size > 1:
        state = SH.place_env_state(state, env.num_envs, mesh)
        ppo_state = SH.place_train_state(ppo_state, mesh)
        shard = env.shard_env_axis(mesh)
        sampler = SH.ShardedSampler(sampler, shard)
    state, ppo_state, m = train_iteration(env, ac, ppo_args, state,
                                          ppo_state, sampler,
                                          num_steps=N_STEPS)
    if env.shard is not None:
        state = SH.gather_env_state(state, env.shard)
    if mesh.rank != 0:
        return None
    return dict(
        metrics={k: v.detach().clone() for k, v in m.items()},
        params={k: v.detach().clone() for k, v in ac.state_dict().items()},
        lr=ppo_state.lr, curriculum=state.curriculum, sim=state.sim,
        commands=state.commands, bins=state.env_command_bins)


def curriculum_cases():
    """[(inputs, kwargs)] of curriculum updates on config_mini_cheetah's
    grid, 16 envs each: rewards just above, at and just below both
    thresholds, success bins at the grid's corners (their envs succeed);
    three cases with
    unique bins, one with bins repeated (its per-bin logs take the last
    writer, which is defined on the CPU)."""
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.envs import curriculum as curr
    cfg = config_mini_cheetah()
    grid = curr.make_grid(cfg)
    L = grid.num_bins
    nx, ny, nz = grid.shape
    rng = np.random.default_rng(0)
    out = []
    for seed in range(4):
        n = N_ENVS
        corners = [0, L - 1, nz - 1, (nx - 1) * ny * nz, ny * nz - 1,
                   L - ny * nz]
        rest = (rng.choice(L, n - len(corners), replace=False) if seed < 3
                else rng.choice(corners[:3], n - len(corners)))
        bins = np.array(corners + list(rest))
        lt, at = 0.8 * 0.02 * (seed + 1), 0.5 * 0.01 * (seed + 1)
        eps = np.float32(1e-6)
        lin = np.float32(lt) + rng.choice([-eps, 0.0, eps, 1.0], n)
        ang = np.float32(at) + rng.choice([-eps, 0.0, eps, 1.0], n)
        mask = rng.uniform(size=n) < 0.8
        # the corner bins succeed: the stencil is clipped at the edges
        lin[:len(corners)] += 1.0
        ang[:len(corners)] += 1.0
        mask[:len(corners)] = True
        raw = rng.normal(size=(3, n))
        state = curr.init_state(grid, cfg, "cpu")
        state = state._replace(weights=torch.tensor(
            rng.uniform(0, 1, L).astype(np.float32)))
        f = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
        out.append(((grid, state, torch.tensor(bins), f(lin), f(ang),
                     torch.tensor(mask), lt, at),
                    dict(lin_vel_raw=f(raw[0]), ang_vel_raw=f(raw[1]),
                         ep_duration=f(np.abs(raw[2]) * 100))))
    return out


def run_curriculum(mesh):
    """Each case's env-axis inputs split over the ranks and gathered back
    as envs/legged_robot.py gathers them, then the update on every rank;
    rank 0's results."""
    from rapid_locomotion_rl_tpu_torch.envs import curriculum as curr
    results = []
    for args, kw in curriculum_cases():
        grid, state, bins, lin, ang, mask, lt, at = args
        shard = SH.EnvShard(mesh, bins.shape[0], bins.shape[0])
        mine = slice(shard.lo, shard.hi)
        cols = [bins, lin, ang, mask, kw["lin_vel_raw"], kw["ang_vel_raw"],
                kw["ep_duration"]]
        got = SH.gather_env_axis(
            torch.stack([c[mine].float() for c in cols], -1), shard)
        results.append(curr.update(
            grid, state, got[:, 0].long(), got[:, 1], got[:, 2],
            got[:, 3] > 0.5, lt, at, lin_vel_raw=got[:, 4],
            ang_vel_raw=got[:, 5], ep_duration=got[:, 6]))
    return results if mesh.rank == 0 else None


def main(job, rank, world, port, out):
    torch.set_num_threads(1)
    mesh = init(int(rank), int(world), int(port))
    res = (run_iteration if job == "iteration" else run_curriculum)(mesh)
    if res is not None:
        torch.save(res, out)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
