"""The training loop: port of the JAX package's ``learn/runner.py``.

Each iteration is one :func:`.ppo.train_iteration` (rollout + GAE +
5 x 4 minibatch update) on the env's device; the host receives a small
dict of scalar metrics per iteration and does the cadence work: metric
summaries every ``log_freq``, checkpoints every ``save_interval``, eval-env
resets and curriculum dumps every ``eval_freq``.

Checkpoints are the JAX package's layout (:mod:`..utils.checkpoint`):
``train_state_*.pkl`` holds the PPO state (params, both Adam states, the
adaptive LR), the env state, the sampler's generator state under ``key``,
the iteration and the step count; ``ac_weights_*.pkl`` and
``student_policy_latest.params.pkl`` hold the Flax params tree, which the
JAX play scripts read; ``student_policy_latest.pt2`` is the student
policy as a ``torch.export`` program (the port's counterpart of the JAX
package's StableHLO file).

Videos: every ``save_video_interval`` iterations the Runner renders env
0's poses over the last ``_video_window`` rollouts (the rollout's
``_render/*`` log) into ``videos/{it:05d}.gif``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import convert
from ..models.networks import ACArgs, ActorCritic
from ..sampler import Sampler
from ..utils.checkpoint import (export_student_policy, load_pytree,
                                save_pytree)
from ..utils.logger import MetricsLogger
from .caches import DataCaches
from .ppo import PPOArgs, PPOState, init_ppo_state, train_iteration


@dataclass
class RunnerArgs:
    """Reference RunnerArgs."""
    num_steps_per_env: int = 24
    max_iterations: int = 1500
    save_interval: int = 400
    save_video_interval: int = 100
    log_freq: int = 10
    resume: bool = False
    resume_path: Optional[str] = None


class Runner:
    def __init__(self, env, logdir: str,
                 ac_args: Optional[ACArgs] = None,
                 ppo_args: Optional[PPOArgs] = None,
                 runner_args: Optional[RunnerArgs] = None,
                 seed: int = 0, eval_expert: bool = False,
                 device=None):
        self.env = env
        self.device = torch.device(device or env.device)
        self.ac_args = ac_args or ACArgs()
        self.ppo_args = ppo_args or PPOArgs()
        self.args = runner_args or RunnerArgs()
        self.logger = MetricsLogger(logdir)
        self.eval_expert = eval_expert
        self.sampler = Sampler(seed, self.device)
        torch.manual_seed(seed)

        self.ac = ActorCritic(
            num_obs=env.num_obs,
            num_privileged_obs=env.num_privileged_obs,
            num_obs_history=env.num_obs_history,
            num_actions=env.num_actions,
            args=self.ac_args).to(self.device)
        self.ppo_state: PPOState = init_ppo_state(self.ac, self.ppo_args)
        self.env_state = env.initial_state(self.sampler)
        # env-0 pose log of the last rollouts, for the videos
        self._pose_buffer: list = []
        self._video_window = 10
        # per iteration of the last learn(): rollout and update wall
        # times; the last iteration's stored scalar metrics
        self.timings: list = []
        self.last_metrics: dict = {}

        self.tot_timesteps = 0
        self.current_learning_iteration = 0
        nbins = (env.curriculum_grid.num_bins
                 if getattr(env, "curriculum_grid", None) is not None else 1)
        self.caches = DataCaches(nbins)

        self.logger.log_params({
            "Cfg": env.cfg.to_dict(),
            "PPO_Args": dataclasses.asdict(self.ppo_args),
            "AC_Args": dataclasses.asdict(self.ac_args),
            "RunnerArgs": dataclasses.asdict(self.args),
        })
        with open(f"{self.logger.logdir}/.charts.yml", "w") as f:
            f.write(
                "charts:\n"
                "- yKey: train/episode/rew_total/mean\n"
                "  xKey: iterations\n"
                "- yKey: train/episode/rew_tracking_lin_vel/mean\n"
                "  xKey: iterations\n"
                "- yKey: train/episode/command_area/mean\n"
                "  xKey: iterations\n"
                "- type: video\n"
                "  glob: videos/*.gif\n")

    def _reset_eval(self, state):
        mask = (torch.arange(self.env.num_envs, device=self.device)
                >= self.env.num_train_envs)
        return self.env.reset_envs(state, mask, self.sampler)

    # ------------------------------------------------------------------
    def learn(self, num_learning_iterations: int,
              init_at_random_ep_len: bool = False, eval_freq: int = 100):
        logger = self.logger
        logger.start("start", "epoch")

        if init_at_random_ep_len:
            ep = self.sampler.integers(
                "runner/init_ep_len", self.env_state.episode_length.shape, 0,
                self.env.derived.max_episode_length)
            self.env_state = self.env_state._replace(
                episode_length=ep.to(torch.int32))

        tot_iter = self.current_learning_iteration + num_learning_iterations
        self.timings = []
        for it in range(self.current_learning_iteration, tot_iter):
            coef = None
            if self.ppo_args.entropy_warmup_iters > 0:
                # linear 0 -> entropy_coef ramp
                frac = min(1.0, it / float(
                    self.ppo_args.entropy_warmup_iters))
                coef = float(np.float32(self.ppo_args.entropy_coef * frac))
            timings = {}
            self.env_state, self.ppo_state, metrics = train_iteration(
                self.env, self.ac, self.ppo_args, self.env_state,
                self.ppo_state, self.sampler, entropy_coef=coef,
                num_steps=self.args.num_steps_per_env, timings=timings,
                eval_expert=self.eval_expert)
            self.timings.append(timings)

            if it % eval_freq == 0 and self.env.num_eval_envs > 0:
                self.env_state = self._reset_eval(self.env_state)
            if it % eval_freq == 0:
                self._dump_curriculum(it)

            self._log_iteration(it, metrics)

            if (self.args.save_video_interval
                    and it % self.args.save_video_interval == 0):
                self._log_video(it)

            if it > 0 and it % self.args.save_interval == 0:
                self.save_checkpoint(it)
            self.current_learning_iteration = it + 1

        self.save_checkpoint(self.current_learning_iteration - 1, final=True)

    # ------------------------------------------------------------------
    def _log_iteration(self, it: int, metrics):
        logger = self.logger
        m = {k: v.detach().cpu().numpy() for k, v in metrics.items()}

        # env-0 pose log of the rollout -> host ring buffer for the videos
        if any(k.startswith("_render/") for k in m):
            self._pose_buffer.append(tuple(
                m.pop(f"_render/{n}") for n in ("pos", "quat", "q",
                                                "origin")))
            del self._pose_buffer[:-self._video_window]

        # per-bin sysid residual -> SlotCache
        if "sysid_residual_sum" in m:
            self.caches.slot_cache.log_sums(
                "sysid_residual", m.pop("sysid_residual_sum"),
                m.pop("sysid_residual_count"))

        # episode metrics: means over the envs that reset
        n_rt = float(m.pop("train_reset_count", 0.0))
        n_re = float(m.pop("eval_reset_count", 0.0))
        store = {}
        for k in list(m.keys()):
            if k.startswith("train/episode/") and k.endswith("/sum"):
                if n_rt > 0:
                    store[k[: -len("/sum")]] = float(m.pop(k)) / n_rt
                else:
                    m.pop(k)
            elif k.startswith("eval/episode/") and k.endswith("/sum"):
                if n_re > 0:
                    store[k[: -len("/sum")]] = float(m.pop(k)) / n_re
                else:
                    m.pop(k)
        for k, v in m.items():
            if np.ndim(v) == 0:
                store[k] = float(v)
        self.last_metrics = store
        logger.store_metrics(
            time_elapsed=logger.since("start"),
            time_iter=logger.split("epoch"),
            **store)

        self.tot_timesteps += (self.args.num_steps_per_env
                               * self.env.num_envs)
        if it % self.args.log_freq == 0:
            row = logger.log_metrics_summary(
                key_values={"timesteps": self.tot_timesteps,
                            "iterations": it})
            rew = row.get("train/episode/rew_total/mean", float("nan"))
            steps_s = (self.args.num_steps_per_env * self.env.num_envs
                       / max(row.get("time_iter/mean", 1e9), 1e-9))
            print(f"it {it:5d} | rew_total {rew:8.3f} | "
                  f"{steps_s:9.0f} env-steps/s | "
                  f"kl {row.get('kl/mean', float('nan')):.4f} | "
                  f"lr {row.get('lr/mean', float('nan')):.2e}")

    def _log_video(self, it: int):
        """Video of env 0 over the last ``_video_window`` training rollouts
        (the reference renders a separate deterministic rollout,
        ppo/__init__.py:267-286; here the poses ride the training rollout).
        The HLP state logs no pose, so an HLP run writes no video; without
        Pillow nothing is written."""
        if not self._pose_buffer:
            return
        from ..utils.render import env_terrain, render_trajectory
        pos, quat, q, origin = (
            np.concatenate([b[i] for b in self._pose_buffer])
            for i in range(4))
        out = render_trajectory(
            self.env.model, pos, quat, q, origin,
            f"{self.logger.logdir}/videos/{it:05d}.gif",
            stride=4, title=f"iter {it}", terrain=env_terrain(self.env))
        if out:
            print(f"video -> {out}")

    def _dump_curriculum(self, it: int):
        """curriculum/info.pkl: the SlotCache/DistCache summaries and the
        per-bin curriculum state."""
        if not hasattr(self.env_state, "curriculum"):
            return   # the HLP state has no command curriculum
        c = self.env_state.curriculum
        self.logger.save_pkl(
            {"iteration": it,
             **self.caches.slot_cache.get_summary(),
             **self.caches.dist_cache.get_summary(),
             **{f: getattr(c, f).detach().cpu().numpy()
                for f in ("weights", "episode_reward_lin",
                          "episode_reward_ang", "episode_lin_vel_raw",
                          "episode_ang_vel_raw", "episode_duration")}},
            path="curriculum/info.pkl", append=True)

    # ------------------------------------------------------------------
    def save_checkpoint(self, it: int, final: bool = False):
        ckpt_dir = f"{self.logger.logdir}/checkpoints"
        payload = dict(
            ppo_state=convert.ppo_state_to_jax(self.ac, self.ppo_state),
            env_state=convert.state_to_jax(self.env_state),
            key=self.sampler.generator.get_state().numpy(),
            iteration=self.current_learning_iteration,
            tot_timesteps=self.tot_timesteps)
        save_pytree(payload, f"{ckpt_dir}/train_state_{it:06d}.pkl")
        save_pytree(payload, f"{ckpt_dir}/train_state_last.pkl")
        params = payload["ppo_state"].params
        save_pytree(params, f"{ckpt_dir}/ac_weights_{it:06d}.pkl")
        save_pytree(params, f"{ckpt_dir}/ac_weights_last.pkl")
        export_student_policy(self.ac, params, self.env.num_obs,
                              self.env.num_obs_history,
                              f"{ckpt_dir}/student_policy_latest")

    def load_checkpoint(self, path: str):
        """Resume from a train-state file of this port or of the JAX
        package: params, both Adam states, the LR, the env state, the
        iteration and the step count. The port's files also restore the
        sampler; a JAX PRNG key has no torch counterpart and leaves the
        sampler as it is."""
        payload = load_pytree(path)
        self.ppo_state = convert.ppo_state_from_jax(
            payload["ppo_state"], self.ac, self.ppo_args)
        self.env_state = convert.state_from_jax(payload["env_state"],
                                                self.device)
        key = np.asarray(payload["key"])
        if key.dtype == np.uint8:
            self.sampler.generator.set_state(torch.from_numpy(key.copy()))
        self.current_learning_iteration = int(payload["iteration"])
        self.tot_timesteps = int(payload["tot_timesteps"])

    # ------------------------------------------------------------------
    def get_inference_policy(self):
        """Deployment policy: dict obs -> student actions."""
        ac = self.ac

        @torch.no_grad()
        def policy(obs_dict):
            return ac.act_student(obs_dict["obs"], obs_dict["obs_history"])
        return policy

    def get_expert_policy(self):
        ac = self.ac

        @torch.no_grad()
        def policy(obs_dict):
            return ac.act_teacher(obs_dict["obs"], obs_dict["privileged_obs"])
        return policy
