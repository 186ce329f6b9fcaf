"""Hierarchical high-level policy (HLP) environment: goal navigation by
driving a FROZEN low-level locomotion policy with velocity commands. Port
of the JAX package's ``envs/hlp.py``.

One HLP step:

    hl_action (vx, vy, wz) -> low-level commands
    ll_action = student_policy(ll_obs, ll_obs_history)   # frozen
    ll_env.step(...)                                     # auto_reset=False
    hl reward / termination / masked resets

- 14-d obs = base_pos(3) + base_lin_vel(3) + base_ang_vel(3) + actions(3)
  + goal(2); actions clamped to +-2, xy commands of norm <= ``dead_zone``
  zeroed;
- step rewards x dt: distance -0.1, action_rate -0.01, lateral_vel -0.05,
  backward_vel -0.005, and the optional ``action_magnitude`` (x dt) and
  ``progress`` (a potential difference, not x dt); terminal rewards (not
  x dt): goal reached +5, low-level termination -2, timeout -1;
- termination: goal within ``goal_radius`` | low-level done | 10 s;
- 95/5 train/eval env split;
- ``zero_reward_on_reset`` (default True) zeroes the reward of the envs
  that reset after the terminal rewards were added, as the reference does,
  so that the learner never sees them.

Every random draw is the low-level env's, through its Sampler.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..models.networks import ActorCritic
from ..ops import quat as Q
from .legged_robot import EnvState, LeggedRobotEnv, StepResult, _w


class HLPRewardScales:
    """The reference's HLP reward scales."""
    # terminal (not dt-scaled)
    terminal_distance_covered = 0.0
    terminal_distance_gs = 5.0
    terminal_ll_reset = -2.0
    terminal_time_out = -1.0
    # per-step (dt-scaled)
    distance = -0.1
    action_rate = -0.01
    lateral_vel = -0.05
    backward_vel = -0.005
    # L2 penalty on the commanded velocities (not in the reference; off):
    # action_rate penalises changes only, so a saturated constant command
    # costs nothing
    action_magnitude = 0.0
    # potential-based progress shaping (not in the reference; off):
    # r += scale * (dist(last_pos, goal) - dist(pos, goal)) telescopes over
    # the episode, so it leaves the optimal policy unchanged
    progress = 0.0


class HLPState(NamedTuple):
    ll: EnvState
    actions: torch.Tensor          # [N,3]
    last_actions: torch.Tensor     # [N,3]
    episode_length: torch.Tensor   # [N] int32
    last_pos: torch.Tensor         # [N,3] base pos rel. to env origin
    dist_travelled: torch.Tensor   # [N]
    goal_position: torch.Tensor    # [N,2]
    episode_sums: Dict[str, torch.Tensor]
    obs: torch.Tensor              # [N,14]
    privileged_obs: torch.Tensor   # [N,18] (zeros)
    obs_history: torch.Tensor      # [N,16] (zeros)


class HighLevelControlEnv:
    """Goal-navigation env over a frozen low-level policy ``ll_ac`` (an
    :class:`ActorCritic` with its weights loaded, on the env's device)."""

    num_obs = 14
    num_actions = 3
    num_privileged_obs = 18
    num_obs_history = 16
    max_episode_length_s = 10.0

    def __init__(self, ll_env: LeggedRobotEnv, ll_ac: ActorCritic,
                 goal=(3.0, 0.0), train_frac: float = 0.95,
                 zero_reward_on_reset: bool = True,
                 scales: type = HLPRewardScales,
                 dead_zone: float = 0.2, goal_radius: float = 0.1):
        if ll_env.cfg.env.auto_reset:
            raise ValueError("the low-level env must be built with "
                             "env.auto_reset=False")
        self.ll_env = ll_env
        self.ll_ac = ll_ac.requires_grad_(False)
        self.device = ll_env.device
        self.num_envs = ll_env.num_envs
        self.num_train_envs = max(1, int(self.num_envs * train_frac))
        self.num_eval_envs = self.num_envs - self.num_train_envs
        self.dt = ll_env.dt
        self.max_episode_length = int(self.max_episode_length_s / self.dt)
        self.goal = torch.tensor(goal, dtype=torch.float32,
                                 device=self.device)
        self.zero_reward_on_reset = zero_reward_on_reset
        # the reference zeroes xy commands of norm <= 0.2; 0 removes the
        # flat spot that freezes the final approach
        self.dead_zone = float(dead_zone)
        # the reference's goal tolerance is 0.1 m; a wider disc lets the
        # +5 bonus be sampled under exploration
        self.goal_radius = float(goal_radius)
        self._init_pos = torch.tensor(ll_env.cfg.init_state.pos,
                                      dtype=torch.float32, device=self.device)

        self.step_scales = {
            k: getattr(scales, k) * self.dt
            for k in ("distance", "action_rate", "lateral_vel",
                      "backward_vel")
            if getattr(scales, k) != 0.0}
        if getattr(scales, "action_magnitude", 0.0) != 0.0:
            self.step_scales["action_magnitude"] = (
                getattr(scales, "action_magnitude") * self.dt)
        # a potential difference per step: not dt-scaled
        if getattr(scales, "progress", 0.0) != 0.0:
            self.step_scales["progress"] = getattr(scales, "progress")
        self.terminal_scales = {
            k: getattr(scales, k)
            for k in ("terminal_distance_covered", "terminal_distance_gs",
                      "terminal_ll_reset", "terminal_time_out")
            if getattr(scales, k) != 0.0}
        self.episode_sum_keys = (list(self.step_scales)
                                 + list(self.terminal_scales) + ["total"])

    # ------------------------------------------------------------------
    def _base_pos(self, ll: EnvState) -> torch.Tensor:
        return ll.sim.base_pos - ll.env_origins - self._init_pos

    def initial_state(self, sampler) -> HLPState:
        ll = self.ll_env.initial_state(sampler)
        ll = ll._replace(commands=torch.cat(
            [torch.zeros_like(ll.commands[:, :3]), ll.commands[:, 3:]], -1))
        N = self.num_envs
        z = lambda *s: torch.zeros(s, device=self.device)  # noqa: E731
        state = HLPState(
            ll=ll, actions=z(N, 3), last_actions=z(N, 3),
            episode_length=torch.zeros(N, dtype=torch.int32,
                                       device=self.device),
            last_pos=self._base_pos(ll), dist_travelled=z(N),
            goal_position=self.goal.expand(N, 2).clone(),
            episode_sums={k: z(N) for k in self.episode_sum_keys},
            obs=z(N, self.num_obs),
            privileged_obs=z(N, self.num_privileged_obs),
            obs_history=z(N, self.num_obs_history))
        return state._replace(obs=self._observe(state, z(N, 3)))

    def _observe(self, state: HLPState, actions) -> torch.Tensor:
        sim = state.ll.sim
        base_lin = Q.quat_rotate_inverse(sim.base_quat, sim.base_lin_vel)
        base_ang = Q.quat_rotate_inverse(sim.base_quat, sim.base_ang_vel)
        return torch.cat([self._base_pos(state.ll), base_lin, base_ang,
                          actions, state.goal_position], dim=-1)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, state: HLPState, actions: torch.Tensor, sampler
             ) -> Tuple[HLPState, StepResult]:
        N = self.num_envs
        dev = self.device
        actions = torch.clamp(actions, -2.0, 2.0)
        if self.dead_zone > 0.0:
            keep = (torch.linalg.norm(actions[:, :2], dim=-1)
                    > self.dead_zone)[:, None]
            actions = torch.cat([actions[:, :2] * keep.to(actions.dtype),
                                 actions[:, 2:]], dim=-1)

        # the frozen low-level student policy drives the low-level env
        ll = state.ll._replace(commands=torch.cat(
            [actions, state.ll.commands[:, 3:]], dim=-1))
        ll_actions = self.ll_ac.act_student(ll.obs, ll.obs_history)
        ll, ll_res = self.ll_env.step(ll, ll_actions, sampler)
        ll_dones = ll_res.done

        episode_length = state.episode_length + 1

        base_pos = self._base_pos(ll)
        base_lin = Q.quat_rotate_inverse(ll.sim.base_quat,
                                         ll.sim.base_lin_vel)
        dist_travelled = state.dist_travelled + torch.linalg.norm(
            base_pos - state.last_pos, dim=-1)
        lateral_vel = base_lin[:, 1]
        backward_vel = torch.clamp(base_lin[:, 0], max=0.0)

        # termination
        gs_buf = torch.linalg.norm(base_pos[:, :2] - state.goal_position,
                                   dim=-1) < self.goal_radius
        time_buf = episode_length > self.max_episode_length
        reset_buf = ll_dones | gs_buf | time_buf

        # rewards; distance is the pre-step one (last_pos)
        dist_last = torch.linalg.norm(
            state.last_pos[:, :2] - state.goal_position, dim=-1)
        dist_now = torch.linalg.norm(base_pos[:, :2] - state.goal_position,
                                     dim=-1)
        terms = {
            "distance": lambda: dist_last,
            "action_rate": lambda: torch.sum(
                (state.last_actions - actions) ** 2, dim=-1),
            "lateral_vel": lambda: lateral_vel ** 2,
            "backward_vel": lambda: backward_vel ** 2,
            "progress": lambda: dist_last - dist_now,
            "action_magnitude": lambda: torch.sum(actions ** 2, dim=-1),
        }
        terminal_terms = {
            "terminal_distance_covered": lambda: dist_travelled,
            "terminal_distance_gs": lambda: gs_buf.float(),
            "terminal_ll_reset": lambda: ll_dones.float(),
            "terminal_time_out": lambda: time_buf.float(),
        }
        rew_buf = torch.zeros(N, device=dev)
        episode_sums = dict(state.episode_sums)
        for k, scale in self.step_scales.items():
            r = terms[k]() * scale
            rew_buf = rew_buf + r
            episode_sums[k] = episode_sums[k] + r
        for k, scale in self.terminal_scales.items():
            r = terminal_terms[k]() * scale
            rew_buf = rew_buf + r
            episode_sums[k] = episode_sums[k] + r
        episode_sums["total"] = episode_sums["total"] + rew_buf

        # episode metrics of the envs that reset
        train_mask = torch.arange(N, device=dev) < self.num_train_envs
        reset_train = reset_buf & train_mask
        reset_eval = reset_buf & ~train_mask
        info: Dict[str, Any] = {
            "train_reset_count": torch.sum(reset_train),
            "eval_reset_count": torch.sum(reset_eval),
            "time_outs": time_buf,
            "env_bins": torch.zeros(N, dtype=torch.int32, device=dev),
            "goal_reached_count": torch.sum(gs_buf),
        }
        for k in self.episode_sum_keys:
            info[f"train/episode/rew_{k}/sum"] = torch.sum(
                torch.where(reset_train, episode_sums[k], 0.0))
            info[f"eval/episode/rew_{k}/sum"] = torch.sum(
                torch.where(reset_eval, episode_sums[k], 0.0))
        for k in episode_sums:
            episode_sums[k] = torch.where(reset_buf, 0.0, episode_sums[k])

        # masked resets: the HLP buffers and the low level
        ll = self.ll_env.reset_envs(ll, reset_buf, sampler)
        if self.zero_reward_on_reset:
            rew_buf = torch.where(reset_buf, 0.0, rew_buf)

        new_state = HLPState(
            ll=ll, actions=actions, last_actions=actions,
            episode_length=torch.where(reset_buf, 0, episode_length
                                       ).to(torch.int32),
            last_pos=self._base_pos(ll),
            dist_travelled=torch.where(reset_buf, 0.0, dist_travelled),
            goal_position=state.goal_position, episode_sums=episode_sums,
            obs=state.obs, privileged_obs=state.privileged_obs,
            obs_history=state.obs_history)
        obs = self._observe(new_state, actions)
        new_state = new_state._replace(obs=obs)
        return new_state, StepResult(
            obs=obs, privileged_obs=new_state.privileged_obs,
            obs_history=new_state.obs_history, rew=rew_buf, done=reset_buf,
            info=info)

    # ------------------------------------------------------------------
    def reset_envs(self, state: HLPState, mask: torch.Tensor, sampler
                   ) -> HLPState:
        """Masked reset of the HLP buffers and the low level (the eval-env
        resets of the Runner)."""
        ll = self.ll_env.reset_envs(state.ll, mask, sampler)
        return state._replace(
            ll=ll,
            episode_length=torch.where(mask, 0, state.episode_length
                                       ).to(torch.int32),
            dist_travelled=torch.where(mask, 0.0, state.dist_travelled),
            last_pos=_w(mask, self._base_pos(ll), state.last_pos),
            episode_sums={k: torch.where(mask, 0.0, v)
                          for k, v in state.episode_sums.items()})
