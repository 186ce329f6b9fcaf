"""PPO's collection half: the policy rollout (port of ``rollout`` in the JAX
package's ``learn/ppo.py``). The update (GAE, minibatch epochs, the
adaptive-KL learning rate, the adaptation-module distillation) is not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from ..models.networks import ActorCritic, normal_log_prob


@dataclass
class PPOArgs:
    """Reference PPO_Args (the JAX package's defaults)."""
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    entropy_coef: float = 0.01
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    learning_rate: float = 1e-3
    adaptation_module_learning_rate: float = 1e-3
    num_adaptation_module_substeps: int = 1
    schedule: str = "adaptive"
    gamma: float = 0.99
    lam: float = 0.95
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    max_lr: float = 1e-2
    entropy_warmup_iters: int = 300


class Transition(NamedTuple):
    """One rollout slot; ``rollout`` stacks them on a leading time axis."""
    obs: torch.Tensor
    privileged_obs: torch.Tensor
    obs_history: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    values: torch.Tensor
    log_prob: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor
    env_bins: torch.Tensor


@torch.no_grad()
def rollout(env, ac: ActorCritic, ppo_args: PPOArgs, env_state, sampler,
            num_steps: int
            ) -> Tuple[Any, Transition, Dict[str, torch.Tensor]]:
    """Collect ``num_steps`` transitions with the current policy: every env
    acts stochastically through the teacher policy. Returns the final env
    state, the stacked transitions [T, N, ...] and the stacked scalar step
    metrics [T]. Deterministic eval envs are not ported yet."""
    if env.num_eval_envs > 0:
        raise NotImplementedError("eval envs are not ported yet")
    steps: List[Transition] = []
    infos: List[Dict[str, torch.Tensor]] = []
    for _ in range(num_steps):
        obs = env_state.obs
        priv = env_state.privileged_obs
        hist = env_state.obs_history

        mean, std = ac.distribution(obs, priv)
        noise = sampler.normal("action", tuple(mean.shape))
        sampled = mean + std * noise
        values = ac.evaluate(obs, priv)
        log_prob = normal_log_prob(mean, std, sampled)
        actions = sampled

        env_state, res = env.step(env_state, actions, sampler)
        # timeout bootstrap
        rewards = res.rew + ppo_args.gamma * values * res.info["time_outs"]

        steps.append(Transition(
            obs=obs, privileged_obs=priv, obs_history=hist,
            actions=actions, rewards=rewards, dones=res.done,
            values=values, log_prob=log_prob, mu=mean, sigma=std,
            env_bins=res.info["env_bins"]))
        infos.append({k: v for k, v in res.info.items()
                      if k not in ("env_bins", "time_outs")})
    traj = Transition(*(torch.stack(f) for f in zip(*steps)))
    info = {k: torch.stack([i[k] for i in infos]) for k in infos[0]}
    return env_state, traj, info
