"""Limb layout of a quadruped-class tree (host-side NumPy).

A base plus K isomorphic chains of depth D: :func:`detect_limbs` finds the
(D levels x K limbs) layout from a :class:`RobotModel`, and the physics step
(:mod:`.soa_physics`, the CUDA kernel) walks bodies in that order. Only the
NumPy half of the JAX package's ``ops/limb_dynamics.py`` is needed here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass(frozen=True)
class LimbLayout:
    """K chains of depth D hanging off the base."""
    K: int
    D: int
    body_index: np.ndarray   # [D,K] dynamics body index of (level, limb)

    @property
    def joint_index(self) -> np.ndarray:
        return self.body_index - 1   # joint j connects body j+1


def detect_limbs(model) -> Optional[LimbLayout]:
    """Partition bodies 1..nb-1 into equal-depth single-child chains."""
    children: List[List[int]] = [[] for _ in range(model.nb)]
    for i in range(1, model.nb):
        children[int(model.parent[i])].append(i)
    roots = children[0]
    if not roots:
        return None
    chains = []
    for r in roots:
        chain = [r]
        cur = r
        while True:
            cs = children[cur]
            if len(cs) == 0:
                break
            if len(cs) != 1:
                return None
            cur = cs[0]
            chain.append(cur)
        chains.append(chain)
    depth = len(chains[0])
    if any(len(c) != depth for c in chains):
        return None
    if len(chains) * depth != model.nb - 1:
        return None
    body_index = np.asarray(chains, dtype=np.int32).T   # [D,K]
    return LimbLayout(K=len(chains), D=depth, body_index=body_index)


def np_spatial_inertia(mass: float, com: np.ndarray,
                       inertia: np.ndarray) -> np.ndarray:
    """6x6 spatial inertia about the body origin, in float64."""
    c = np.array([[0, -com[2], com[1]],
                  [com[2], 0, -com[0]],
                  [-com[1], com[0], 0]])
    out = np.zeros((6, 6))
    out[:3, :3] = inertia + mass * (c @ c.T)
    out[:3, 3:] = mass * c
    out[3:, :3] = mass * c.T
    out[3:, 3:] = mass * np.eye(3)
    return out


def layout_for(model) -> Optional[LimbLayout]:
    """Limb layout of a model, or None when the tree does not decompose."""
    return detect_limbs(model)
