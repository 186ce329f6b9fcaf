"""Pluggable evaluation metric probes (port of the JAX package's
``learn/metrics.py``).

Re-creates the reference registry (reference
mini_gym_learn/eval_metrics/metrics.py:8-99): each probe maps
``(env, env_state, ac, params)`` to a tensor (a scalar, or per-env rows)
or a dict of them, evaluated on live rollout state. Names, order and
semantics match the JAX package's ``METRICS_FNS``. The port's
:class:`..models.networks.ActorCritic` holds its own weights, so
``params`` is unused (pass None).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..ops import quat as Q


def _base_lin_vel(env_state):
    return Q.quat_rotate_inverse(env_state.sim.base_quat,
                                 env_state.sim.base_lin_vel)


def _base_ang_vel(env_state):
    return Q.quat_rotate_inverse(env_state.sim.base_quat,
                                 env_state.sim.base_ang_vel)


def lin_vel_rmsd(env, env_state, ac=None, params=None):
    """RMS deviation of commanded vs achieved planar velocity
    (metrics.py:8)."""
    err = env_state.commands[:, :2] - _base_lin_vel(env_state)[:, :2]
    return torch.sqrt(torch.mean(torch.sum(err ** 2, dim=-1)))


def ang_vel_rmsd(env, env_state, ac=None, params=None):
    err = env_state.commands[:, 2] - _base_ang_vel(env_state)[:, 2]
    return torch.sqrt(torch.mean(err ** 2))


def mechanical_power(env, env_state, ac=None, params=None):
    """Positive mechanical power P = Σ max(τ·q̇, 0) [W]."""
    return torch.mean(torch.sum(
        torch.clamp(env_state.torques * env_state.sim.qd, min=0.0), dim=-1))


def cost_of_transport(env, env_state, ac=None, params=None):
    """CoT = P / (m g v) (metrics.py:40-47)."""
    p = torch.sum(torch.clamp(env_state.torques * env_state.sim.qd, min=0.0),
                  dim=-1)
    v = torch.linalg.norm(_base_lin_vel(env_state)[:, :2], dim=-1)
    mg = env.model.total_mass() * 9.81
    return torch.mean(p / (mg * torch.clamp(v, min=0.1)))


def froude_number(env, env_state, ac=None, params=None):
    """Fr = v^2 / (g h) (metrics.py:50-55)."""
    v = torch.linalg.norm(_base_lin_vel(env_state)[:, :2], dim=-1)
    h = torch.clamp(env_state.sim.base_pos[:, 2]
                    - env_state.env_origins[:, 2], min=0.05)
    return torch.mean(v ** 2 / (9.81 * h))


@torch.no_grad()
def adaptation_loss(env, env_state, ac, params=None):
    """MSE(adaptation(obs_hist), encoder(priv_obs)) (metrics.py:58-63)."""
    pred = ac.student_latent(env_state.obs_history)
    target = ac.teacher_latent(env_state.privileged_obs)
    return torch.mean((pred - target) ** 2)


def base_height(env, env_state, ac=None, params=None):
    return torch.mean(env_state.sim.base_pos[:, 2]
                      - env_state.env_origins[:, 2])


def contact_rate(env, env_state, ac=None, params=None):
    """Fraction of feet in ground contact."""
    f = env_state.contact_report[:, list(env.feet_indices), 2]
    return torch.mean((f > 1.0).float())


def lin_vel_x(env, env_state, ac=None, params=None):
    """Mean achieved forward body velocity (metrics.py:16-17)."""
    return torch.mean(_base_lin_vel(env_state)[:, 0])


def ang_vel_yaw(env, env_state, ac=None, params=None):
    """Mean achieved yaw rate (metrics.py:20-21)."""
    return torch.mean(_base_ang_vel(env_state)[:, 2])


def max_torques(env, env_state, ac=None, params=None):
    """Mean over envs of the per-env max |torque| (metrics.py:29-33)."""
    return torch.mean(torch.amax(torch.abs(env_state.torques), dim=-1))


def power_consumption(env, env_state, ac=None, params=None):
    """Signed Σ τ·q̇: the reference's unclipped power (metrics.py:35-38;
    ``mechanical_power`` above is the positive-work variant)."""
    return torch.mean(torch.sum(env_state.torques * env_state.sim.qd,
                                dim=-1))


def auxiliary_rewards(env, env_state, ac=None, params=None):
    """Per-term scaled instantaneous rewards as a dict (metrics.py:66-72;
    the reference's ``return`` sits inside its loop so it only ever
    reports the first term; here the full registry is returned)."""
    return {k: torch.mean(v) for k, v in env.reward_terms(env_state).items()}


def termination(env, env_state, ac=None, params=None):
    """Fraction of envs terminating this step (metrics.py:75-77)."""
    return torch.mean(env_state.reset_buf.float())


def privileged_obs(env, env_state, ac=None, params=None):
    """Raw scale-shifted privileged observations (metrics.py:79-81)."""
    return env_state.privileged_obs


@torch.no_grad()
def latents(env, env_state, ac=None, params=None):
    """Teacher latent e = encoder(priv_obs) (metrics.py:83-85)."""
    return ac.teacher_latent(env_state.privileged_obs)


METRICS_FNS: Dict[str, Callable] = {
    "lin_vel_rmsd": lin_vel_rmsd,
    "ang_vel_rmsd": ang_vel_rmsd,
    "lin_vel_x": lin_vel_x,
    "ang_vel_yaw": ang_vel_yaw,
    "max_torques": max_torques,
    "power_consumption": power_consumption,
    "mechanical_power": mechanical_power,
    "cost_of_transport": cost_of_transport,
    "froude_number": froude_number,
    "adaptation_loss": adaptation_loss,
    "auxiliary_rewards": auxiliary_rewards,
    "termination": termination,
    "privileged_obs": privileged_obs,
    "latents": latents,
    "base_height": base_height,
    "contact_rate": contact_rate,
}
