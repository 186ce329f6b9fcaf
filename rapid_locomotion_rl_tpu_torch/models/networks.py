"""RMA-style teacher-student actor-critic (port of the JAX package's
``models/networks.py``).

- ``env_factor_encoder``: privileged obs (18) -> [256,128] -> latent (18)
- ``adaptation_module``: obs history (630) -> [256,32] -> latent (18)
- ``actor_body`` / ``critic_body``: [obs ‖ latent] -> [512,256,128] -> out
- state-independent learned std, floored at ``min_std``

Each MLP keeps its layers in ``layers`` so that Flax's ``Dense_i`` maps to
``layers.i`` (:func:`..convert.params_from_flax`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclass
class ACArgs:
    """Reference AC_Args."""
    init_noise_std: float = 1.0
    actor_hidden_dims: List[int] = field(default_factory=lambda: [512, 256, 128])
    critic_hidden_dims: List[int] = field(default_factory=lambda: [512, 256, 128])
    activation: str = "elu"
    adaptation_module_branch_hidden_dims: List[int] = field(
        default_factory=lambda: [256, 32])
    env_factor_encoder_branch_hidden_dims: List[int] = field(
        default_factory=lambda: [256, 128])
    env_factor_encoder_branch_latent_dims: int = 18
    use_latent: bool = True
    # exploration floor on the learned std (0.0 = off = reference parity)
    min_std: float = 0.2


_ACTIVATIONS = {
    "elu": F.elu, "relu": F.relu, "selu": F.selu, "crelu": F.relu,
    "lrelu": lambda x: F.leaky_relu(x, 0.01), "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


class MLP(nn.Module):
    def __init__(self, n_in: int, hidden: Sequence[int], out: int,
                 act: str = "elu"):
        super().__init__()
        dims = [n_in, *hidden, out]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.act = _ACTIVATIONS[act]
        # Flax Dense's initialisation: LeCun normal kernels (a normal of
        # variance 1/fan_in truncated at two standard deviations, rescaled
        # to keep that variance) and zero biases
        for layer in self.layers:
            std = math.sqrt(1.0 / layer.in_features) / .87962566103423978
            nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std,
                                  b=2 * std)
            nn.init.zeros_(layer.bias)

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = self.act(layer(x))
        return self.layers[-1](x)


class ActorCritic(nn.Module):
    def __init__(self, num_obs: int, num_privileged_obs: int,
                 num_obs_history: int, num_actions: int, args: ACArgs):
        super().__init__()
        self.args = a = args
        lat = a.env_factor_encoder_branch_latent_dims if a.use_latent else 0
        if a.use_latent:
            self.env_factor_encoder = MLP(
                num_privileged_obs, a.env_factor_encoder_branch_hidden_dims,
                lat, a.activation)
            self.adaptation_module = MLP(
                num_obs_history, a.adaptation_module_branch_hidden_dims,
                lat, a.activation)
        self.actor_body = MLP(num_obs + lat, a.actor_hidden_dims,
                              num_actions, a.activation)
        self.critic_body = MLP(num_obs + lat, a.critic_hidden_dims, 1,
                               a.activation)
        self.std = nn.Parameter(torch.full((num_actions,), a.init_noise_std))

    # -- latent paths ----------------------------------------------------
    def teacher_latent(self, privileged_obs):
        return self.env_factor_encoder(privileged_obs)

    def student_latent(self, obs_history):
        return self.adaptation_module(obs_history)

    def _actor_in(self, obs, latent):
        if self.args.use_latent:
            return torch.cat([obs, latent], dim=-1)
        return obs

    # -- heads -----------------------------------------------------------
    def act_teacher(self, obs, privileged_obs):
        """Deterministic teacher action mean."""
        latent = (self.teacher_latent(privileged_obs)
                  if self.args.use_latent else None)
        return self.actor_body(self._actor_in(obs, latent))

    def act_student(self, obs, obs_history):
        """Deployment path: adaptation-module latent."""
        latent = (self.student_latent(obs_history)
                  if self.args.use_latent else None)
        return self.actor_body(self._actor_in(obs, latent))

    def distribution(self, obs, privileged_obs
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, std) of the teacher policy."""
        mean = self.act_teacher(obs, privileged_obs)
        std = torch.clamp(self.std, min=max(1e-4, self.args.min_std))
        return mean, std.expand_as(mean)

    def evaluate(self, obs, privileged_obs):
        latent = (self.teacher_latent(privileged_obs)
                  if self.args.use_latent else None)
        return self.critic_body(self._actor_in(obs, latent))[..., 0]

    def forward(self, obs, privileged_obs, obs_history):
        mean, std = self.distribution(obs, privileged_obs)
        value = self.evaluate(obs, privileged_obs)
        student = (self.act_student(obs, obs_history)
                   if self.args.use_latent else mean)
        return mean, std, value, student


# ---------------------------------------------------------------------------
def normal_log_prob(mean, std, x):
    """Diagonal Normal log-likelihood summed over the action axis."""
    var = std * std
    return torch.sum(
        -0.5 * ((x - mean) ** 2) / var - torch.log(std)
        - 0.5 * math.log(2.0 * math.pi), dim=-1)


def normal_entropy(std):
    """Diagonal Normal entropy summed over the action axis."""
    return torch.sum(0.5 + 0.5 * math.log(2.0 * math.pi) + torch.log(std),
                     dim=-1)



def normal_kl(mu0, sig0, mu1, sig1):
    """KL(N0 || N1) summed over the action axis (the adaptive-LR
    estimate)."""
    return torch.sum(
        torch.log(sig1 / sig0 + 1e-5)
        + (sig0 ** 2 + (mu0 - mu1) ** 2) / (2.0 * sig1 ** 2) - 0.5,
        dim=-1)
