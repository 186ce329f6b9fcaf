"""Trajectory splitting and padding for recurrent PPO: port of the JAX
package's ``learn/trajectories.py``.

Re-creates the reference utility: split a [T, N, ...] rollout tensor at
its done flags into per-episode trajectories, padded to the rollout
length, with validity masks (the input of the recurrent minibatch
generator). The layout is dense and static: M = T * N trajectory slots,
the first ones filled env by env; consumers mask with ``masks``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _trajectory_index(dones: torch.Tensor):
    """(trajectory id [T, N], position within it [T, N]) of every step:
    a trajectory starts at step 0 and after every done, ids count env by
    env."""
    T, N = dones.shape[:2]
    d = dones.bool()
    starts = torch.cat([torch.ones((1, N), dtype=torch.bool,
                                   device=d.device), d[:-1]], dim=0)
    traj_id = (torch.cumsum(starts.T.reshape(-1).long(), 0) - 1
               ).reshape(N, T).T
    t_idx = torch.arange(T, device=d.device)[:, None].expand(T, N)
    first_t = torch.full((T * N,), T, dtype=torch.long, device=d.device)
    first_t = first_t.scatter_reduce(0, traj_id.T.reshape(-1),
                                     t_idx.T.reshape(-1), reduce="amin")
    return traj_id, t_idx - first_t[traj_id]


def split_and_pad_trajectories(tensor: torch.Tensor, dones: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split ``tensor`` [T, N, ...] at ``dones`` [T, N] and pad to the
    rollout length. Returns (padded [T, M, ...], masks [T, M]) with
    M = T * N; masks[t, j] marks valid steps."""
    T, N = dones.shape[:2]
    traj_id, pos = _trajectory_index(dones)
    padded = torch.zeros((T, T * N) + tuple(tensor.shape[2:]),
                         dtype=tensor.dtype, device=tensor.device)
    masks = torch.zeros((T, T * N), dtype=torch.bool, device=tensor.device)
    padded[pos, traj_id] = tensor
    masks[pos, traj_id] = True
    return padded, masks


def unpad_trajectories(padded: torch.Tensor, dones: torch.Tensor,
                       num_envs: int) -> torch.Tensor:
    """Inverse of :func:`split_and_pad_trajectories`: the [T, N, ...]
    elements gathered back out of the padded layout; ``dones`` is the same
    [T, N] array the forward pass used."""
    if dones.shape[1] != num_envs:
        raise ValueError(f"dones has {dones.shape[1]} envs, not {num_envs}")
    traj_id, pos = _trajectory_index(dones)
    return padded[pos, traj_id]


def recurrent_mini_batches(data: dict, dones: torch.Tensor,
                           num_mini_batches: int) -> list:
    """The reference's recurrent minibatch generator: the env axis split
    into ``num_mini_batches`` static groups of N // num_mini_batches envs;
    the observation-like keys (``obs``, ``priv``, ``hist``) trajectory-
    split and padded per group, with a ``masks`` entry; the other keys
    [T, mb_envs, ...] slices. One list of dicts per epoch."""
    T, N = dones.shape[:2]
    mb = N // num_mini_batches
    out = []
    for i in range(num_mini_batches):
        sl = slice(i * mb, (i + 1) * mb)
        d = dones[:, sl]
        batch = {}
        for k, v in data.items():
            if k in ("obs", "priv", "hist"):
                batch[k], batch["masks"] = split_and_pad_trajectories(
                    v[:, sl], d)
            else:
                batch[k] = v[:, sl]
        out.append(batch)
    return out
