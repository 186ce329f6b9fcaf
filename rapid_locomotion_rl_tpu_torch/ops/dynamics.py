"""Dynamic state and per-env physical parameters of the simulated robot.

Port of the two records of the JAX package's ``ops/dynamics.py`` that the
physics step takes; the generic (non-limb) dynamics there is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SimState(NamedTuple):
    """Dynamic state of the robots, batched on the leading env axis."""
    base_pos: torch.Tensor      # [N,3] world
    base_quat: torch.Tensor     # [N,4] xyzw, body->world
    base_lin_vel: torch.Tensor  # [N,3] world, velocity of base frame origin
    base_ang_vel: torch.Tensor  # [N,3] world
    q: torch.Tensor             # [N,nv] joint positions
    qd: torch.Tensor            # [N,nv] joint velocities


class PhysParams(NamedTuple):
    """Per-env physical properties entering the dynamics."""
    friction: torch.Tensor          # [N] robot shape friction coeff
    restitution: torch.Tensor       # [N]
    payload: torch.Tensor           # [N] added base mass [kg]
    com_displacement: torch.Tensor  # [N,3] base CoM offset [m]
