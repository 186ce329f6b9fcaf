"""Stateful VecEnv adapter over the port's env: port of the JAX package's
``envs/vec_env.py``.

The reference Runner consumes an abstract VecEnv with mutable buffers and
``step``/``reset``/``get_observations``. The port's env is functional
(``env.step(state, actions, sampler)``); this adapter keeps an
:class:`..envs.legged_robot.EnvState` and a :class:`..sampler.Sampler` on
the env's device behind that interface, for scripts, notebooks and ports
of reference code. Training uses the functional API (learn/ppo.py).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..sampler import Sampler
from .legged_robot import LeggedRobotEnv


class VecEnvAdapter:
    def __init__(self, env: LeggedRobotEnv, seed: int = 0):
        self.env = env
        self.device = env.device
        self.num_envs = env.num_envs
        self.num_train_envs = env.num_train_envs
        self.num_eval_envs = env.num_eval_envs
        self.num_obs = env.num_obs
        self.num_privileged_obs = env.num_privileged_obs
        self.num_obs_history = env.num_obs_history
        self.num_actions = env.num_actions
        self.dt = env.dt
        self.max_episode_length = env.derived.max_episode_length
        self.sampler = Sampler(seed, env.device)
        self.state = env.initial_state(self.sampler)
        self.extras: Dict = {}

    def _mask(self, mask) -> None:
        self.state = self.env.reset_envs(self.state, mask, self.sampler)

    # -- the VecEnv interface --------------------------------------------
    def step(self, actions):
        """(obs dict, rew, done, info): the HistoryWrapper's dict obs."""
        actions = torch.as_tensor(actions, dtype=torch.float32,
                                  device=self.device)
        self.state, res = self.env.step(self.state, actions, self.sampler)
        self.extras = dict(res.info)
        obs = {"obs": res.obs, "privileged_obs": res.privileged_obs,
               "obs_history": res.obs_history}
        return obs, res.rew, res.done, self.extras

    def reset(self):
        self._mask(torch.ones(self.num_envs, dtype=torch.bool,
                              device=self.device))
        obs, _, _, _ = self.step(torch.zeros((self.num_envs,
                                              self.num_actions)))
        return obs

    def reset_idx(self, env_ids):
        mask = torch.zeros(self.num_envs, dtype=torch.bool,
                           device=self.device)
        mask[torch.as_tensor(env_ids, device=self.device).long()] = True
        self._mask(mask)

    def reset_evaluation_envs(self):
        self._mask(torch.arange(self.num_envs, device=self.device)
                   >= self.num_train_envs)

    def get_observations(self):
        return {"obs": self.state.obs,
                "privileged_obs": self.state.privileged_obs,
                "obs_history": self.state.obs_history}

    def get_privileged_observations(self):
        return self.state.privileged_obs

    # -- attributes mirrored from the state --------------------------------
    @property
    def episode_length_buf(self):
        return self.state.episode_length

    @episode_length_buf.setter
    def episode_length_buf(self, value):
        self.state = self.state._replace(episode_length=torch.as_tensor(
            value, dtype=torch.int32, device=self.device))

    @property
    def commands(self):
        return self.state.commands

    @property
    def root_states(self):
        """IsaacGym-layout [N, 13] root state view."""
        s = self.state.sim
        return torch.cat([s.base_pos, s.base_quat, s.base_lin_vel,
                          s.base_ang_vel], dim=-1)

    @property
    def dof_pos(self):
        return self.state.sim.q

    @property
    def dof_vel(self):
        return self.state.sim.qd
