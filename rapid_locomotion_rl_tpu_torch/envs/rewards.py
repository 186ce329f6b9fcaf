"""Reward term registry — functions over a step context (port of the JAX
package's ``envs/rewards.py``).

Every active reward of the reference env under the same names, so that the
scale-gated selection and the logged metric names (``train/episode/rew_<name>``)
line up with the JAX package. Each function maps a :class:`RewardContext`
to a per-env [N] tensor.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch


class RewardContext(NamedTuple):
    # body-frame base kinematics (legged_robot.py:159-162)
    base_lin_vel: torch.Tensor        # [N,3]
    base_ang_vel: torch.Tensor        # [N,3]
    projected_gravity: torch.Tensor   # [N,3]
    base_height: torch.Tensor         # [N] root z minus mean measured height
    # joints
    dof_pos: torch.Tensor             # [N,nv]
    default_dof_pos: torch.Tensor     # [nv]
    dof_vel: torch.Tensor             # [N,nv]
    last_dof_vel: torch.Tensor        # [N,nv]
    torques: torch.Tensor             # [N,nv]
    dof_pos_limits: torch.Tensor      # [nv,2] soft limits
    dof_vel_limits: torch.Tensor      # [nv]
    torque_limits: torch.Tensor       # [nv]
    # actions
    actions: torch.Tensor             # [N,na]
    last_actions: torch.Tensor        # [N,na]
    # commands
    commands: torch.Tensor            # [N,>=3]
    # contacts (report-body forces, world frame)
    contact_forces: torch.Tensor      # [N,nr,3]
    feet_indices: tuple              # static
    penalised_contact_indices: tuple
    # gait bookkeeping (computed by the env before reward evaluation)
    feet_air_time_reward: torch.Tensor  # [N] precomputed feet_air_time term
    # termination flags
    reset_buf: torch.Tensor           # [N] bool
    time_out_buf: torch.Tensor        # [N] bool
    # cfg scalars
    tracking_sigma: float
    tracking_sigma_yaw: float
    base_height_target: float
    soft_dof_vel_limit: float
    soft_torque_limit: float
    max_contact_force: float
    dt: float
    global_reference: bool
    root_lin_vel_world: torch.Tensor  # [N,3] for global_reference tracking


def _sq(x):
    return torch.square(x)


def lin_vel_z(c):       # penalize vertical base velocity
    return _sq(c.base_lin_vel[:, 2])


def ang_vel_xy(c):      # penalize base roll/pitch rates
    return torch.sum(_sq(c.base_ang_vel[:, :2]), dim=1)


def orientation(c):     # penalize non-flat base
    return torch.sum(_sq(c.projected_gravity[:, :2]), dim=1)


def base_height(c):
    return _sq(c.base_height - c.base_height_target)


def torques(c):
    return torch.sum(_sq(c.torques), dim=1)


def energy(c):
    return torch.sum(c.torques * c.dof_vel, dim=1)


def energy_expenditure(c):
    return torch.sum(torch.clamp(c.torques * c.dof_vel, 0.0, 1e30), dim=1)


def dof_vel(c):
    return torch.sum(_sq(c.dof_vel), dim=1)


def dof_acc(c):
    return torch.sum(_sq((c.last_dof_vel - c.dof_vel) / c.dt), dim=1)


def action_rate(c):
    return torch.sum(_sq(c.last_actions - c.actions), dim=1)


def collision(c):
    f = c.contact_forces[:, list(c.penalised_contact_indices), :]
    return torch.sum(
        (torch.linalg.norm(f, dim=-1) > 0.1).float(), dim=1)


def termination(c):
    return (c.reset_buf & ~c.time_out_buf).float()


def survival(c):
    return (~(c.reset_buf & ~c.time_out_buf)).float()


def dof_pos_limits(c):
    below = -torch.clamp(c.dof_pos - c.dof_pos_limits[:, 0], max=0.0)
    above = torch.clamp(c.dof_pos - c.dof_pos_limits[:, 1], min=0.0)
    return torch.sum(below + above, dim=1)


def dof_vel_limits(c):
    return torch.sum(
        torch.clamp(torch.abs(c.dof_vel) - c.dof_vel_limits * c.soft_dof_vel_limit,
                    0.0, 1.0), dim=1)


def torque_limits(c):
    return torch.sum(
        torch.clamp(torch.abs(c.torques) - c.torque_limits * c.soft_torque_limit,
                    min=0.0), dim=1)


def tracking_lin_vel(c):
    vel = c.root_lin_vel_world[:, :2] if c.global_reference else c.base_lin_vel[:, :2]
    err = torch.sum(_sq(c.commands[:, :2] - vel), dim=1)
    return torch.exp(-err / c.tracking_sigma)


def tracking_ang_vel(c):
    err = _sq(c.commands[:, 2] - c.base_ang_vel[:, 2])
    return torch.exp(-err / c.tracking_sigma_yaw)


def tracking_lin_vel_lat(c):
    err = _sq(c.commands[:, 1] - c.base_lin_vel[:, 1])
    return torch.exp(-err / c.tracking_sigma)


def tracking_lin_vel_long(c):
    err = _sq(c.commands[:, 0] - c.base_lin_vel[:, 0])
    return torch.exp(-err / c.tracking_sigma)


def feet_air_time(c):
    # computed statefully by the env (contact filtering + air-time buffers,
    # legged_robot.py:1619-1631); passed through the context
    return c.feet_air_time_reward


def feet_stumble(c):
    f = c.contact_forces[:, list(c.feet_indices), :]
    lateral = torch.linalg.norm(f[..., :2], dim=-1)
    return torch.any(lateral > 5.0 * torch.abs(f[..., 2]), dim=1).float()


def stand_still(c):
    still = torch.linalg.norm(c.commands[:, :2], dim=1) < 0.1
    return torch.sum(torch.abs(c.dof_pos - c.default_dof_pos), dim=1) * still


def feet_contact_forces(c):
    f = c.contact_forces[:, list(c.feet_indices), :]
    return torch.sum(
        torch.clamp(torch.linalg.norm(f, dim=-1) - c.max_contact_force, min=0.0),
        dim=1)


REWARD_REGISTRY: Dict[str, Callable[[RewardContext], torch.Tensor]] = {
    "lin_vel_z": lin_vel_z,
    "ang_vel_xy": ang_vel_xy,
    "orientation": orientation,
    "base_height": base_height,
    "torques": torques,
    "energy": energy,
    "energy_expenditure": energy_expenditure,
    "dof_vel": dof_vel,
    "dof_acc": dof_acc,
    "action_rate": action_rate,
    "collision": collision,
    "termination": termination,
    "survival": survival,
    "dof_pos_limits": dof_pos_limits,
    "dof_vel_limits": dof_vel_limits,
    "torque_limits": torque_limits,
    "tracking_lin_vel": tracking_lin_vel,
    "tracking_ang_vel": tracking_ang_vel,
    "tracking_lin_vel_lat": tracking_lin_vel_lat,
    "tracking_lin_vel_long": tracking_lin_vel_long,
    "feet_air_time": feet_air_time,
    "feet_stumble": feet_stumble,
    "stand_still": stand_still,
    "feet_contact_forces": feet_contact_forces,
}
