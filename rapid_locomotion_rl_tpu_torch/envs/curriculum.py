"""Grid Adaptive Curriculum over the (vx, vy, wz) command space (port of
the JAX package's ``envs/curriculum.py``).

An env's command bin is a success when both tracking rewards exceed their
thresholds; successful bins and their L-infinity neighbourhood within
``local_range`` command units gain +0.2 weight (saturating at 1). Commands
are drawn from the normalized weights, then uniformly within the bin cell.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class CurriculumGrid:
    """Static description of the command-space grid."""
    shape: Tuple[int, int, int]          # (nx, ny, nyaw)
    lows: np.ndarray                     # [3] first centroid per dim
    highs: np.ndarray                    # [3] last centroid per dim
    bin_sizes: np.ndarray                # [3] centroid spacing per dim
    stencil: Tuple[int, int, int]        # neighborhood half-extent per dim

    @property
    def num_bins(self) -> int:
        return int(np.prod(self.shape))

    def centroids(self) -> np.ndarray:
        """[L, 3] bin centroids in command space (x-major, like meshgrid ij)."""
        axes = [np.linspace(self.lows[d], self.highs[d], self.shape[d])
                for d in range(3)]
        g = np.stack(np.meshgrid(*axes, indexing="ij"))
        return g.reshape(3, -1).T


class CurriculumState(NamedTuple):
    weights: torch.Tensor             # [L]
    episode_reward_lin: torch.Tensor  # [L] per-bin running logs
    episode_reward_ang: torch.Tensor
    episode_lin_vel_raw: torch.Tensor
    episode_ang_vel_raw: torch.Tensor
    episode_duration: torch.Tensor


def make_grid(cfg, local_range: float = 0.5) -> CurriculumGrid:
    """Build the grid from the command limit ranges."""
    shape = (cfg.commands.curriculum_x_bins, cfg.commands.curriculum_y_bins,
             cfg.commands.curriculum_yaw_bins)
    lows = np.array([cfg.commands.limit_vel_x[0], cfg.commands.limit_vel_y[0],
                     cfg.commands.limit_vel_yaw[0]])
    highs = np.array([cfg.commands.limit_vel_x[1], cfg.commands.limit_vel_y[1],
                      cfg.commands.limit_vel_yaw[1]])
    sizes = np.array([(highs[d] - lows[d]) / max(shape[d] - 1, 1)
                      for d in range(3)])
    stencil = tuple(int(np.floor(local_range / sizes[d] + 1e-9))
                    if sizes[d] > 0 else 0 for d in range(3))
    return CurriculumGrid(shape=shape, lows=lows, highs=highs,
                          bin_sizes=sizes, stencil=stencil)


def init_state(grid: CurriculumGrid, cfg, device) -> CurriculumState:
    """Seed the weights inside the initial command ranges."""
    cent = grid.centroids()
    low = np.array([cfg.commands.lin_vel_x[0], cfg.commands.lin_vel_y[0],
                    cfg.commands.ang_vel_yaw[0]])
    high = np.array([cfg.commands.lin_vel_x[1], cfg.commands.lin_vel_y[1],
                     cfg.commands.ang_vel_yaw[1]])
    inside = np.all((cent >= low) & (cent <= high), axis=-1)
    L = grid.num_bins
    z = lambda: torch.zeros(L, device=device)  # noqa: E731
    return CurriculumState(
        weights=torch.tensor(inside.astype(np.float32), device=device),
        episode_reward_lin=z(), episode_reward_ang=z(),
        episode_lin_vel_raw=z(), episode_ang_vel_raw=z(),
        episode_duration=z())


def _shift(x: torch.Tensor, s: int, dim: int) -> torch.Tensor:
    """x shifted by s along dim, with zeros shifted in (no wrap)."""
    if s == 0:
        return x
    out = torch.roll(x, s, dims=dim)
    idx = torch.arange(x.shape[dim], device=x.device)
    edge = (idx < s) if s > 0 else (idx >= x.shape[dim] + s)
    shape = [1, 1, 1]
    shape[dim] = -1
    return torch.where(edge.reshape(shape), 0.0, out)


def update(grid: CurriculumGrid, state: CurriculumState,
           env_bins: torch.Tensor,        # [N] current bin of every env
           lin_rewards: torch.Tensor,     # [N] normalized tracking_lin reward
           ang_rewards: torch.Tensor,     # [N]
           update_mask: torch.Tensor,     # [N] bool: train envs being resampled
           lin_threshold: float, ang_threshold: float,
           lin_vel_raw=None, ang_vel_raw=None,
           ep_duration=None) -> CurriculumState:
    """Success bins get +0.2 once, plus +0.2 per success env over the
    L-infinity stencil (which includes the bin itself), saturating at 1.
    The per-bin logs are last-writer scatters over the updated envs."""
    L = grid.num_bins
    success = (update_mask & (lin_rewards > lin_threshold)
               & (ang_rewards > ang_threshold))
    hit = torch.zeros(L, device=env_bins.device).index_add_(
        0, env_bins.long(), success.float())
    hit3 = hit.reshape(grid.shape)
    dil = torch.zeros_like(hit3)
    sx, sy, sz = grid.stencil
    for dx in range(-sx, sx + 1):
        for dy in range(-sy, sy + 1):
            for dz in range(-sz, sz + 1):
                dil = dil + _shift(_shift(_shift(hit3, dx, 0), dy, 1), dz, 2)
    increments = 0.2 * ((hit > 0).float() + dil.reshape(-1))
    weights = torch.clamp(state.weights + increments, 0.0, 1.0)

    idx = env_bins[update_mask].long()

    def scatter(dst, vals):
        dst = dst.clone()
        dst[idx] = vals[update_mask].to(dst.dtype)
        return dst

    state = state._replace(
        weights=weights,
        episode_reward_lin=scatter(state.episode_reward_lin, lin_rewards),
        episode_reward_ang=scatter(state.episode_reward_ang, ang_rewards))
    if lin_vel_raw is not None:
        state = state._replace(episode_lin_vel_raw=scatter(
            state.episode_lin_vel_raw, lin_vel_raw))
    if ang_vel_raw is not None:
        state = state._replace(episode_ang_vel_raw=scatter(
            state.episode_ang_vel_raw, ang_vel_raw))
    if ep_duration is not None:
        state = state._replace(episode_duration=scatter(
            state.episode_duration, ep_duration))
    return state


def sample(grid: CurriculumGrid, state: CurriculumState, sampler, n: int,
           stream: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw n commands: weighted bin choice + uniform within the bin cell.
    Returns (commands [n,3], bin_indices [n])."""
    device = state.weights.device
    bins = sampler.categorical(f"{stream}/bins", state.weights, n)
    cent = torch.tensor(grid.centroids(), dtype=torch.float32,
                        device=device)[bins]
    u = sampler.uniform(f"{stream}/cell", (n, 3), -0.5, 0.5)
    cmds = cent + u * torch.tensor(grid.bin_sizes, dtype=torch.float32,
                                   device=device)
    return cmds, bins
