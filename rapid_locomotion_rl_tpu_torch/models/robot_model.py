"""Static robot description consumed by the physics step and its kernel.

Replacement for IsaacGym's asset API (``gym.load_asset`` +
property getters, reference legged_robot.py:1190-1198; SURVEY.md §2.1 N5):
the kinematic tree, joint limits, mass properties and collision geometry are
parsed ONCE on the host into plain NumPy arrays, which the physics step
reads as constants (the CUDA kernel through a packed constant table).

Two body levels exist:

- **dynamics bodies**: the fully merged articulated tree (fixed joints
  collapsed) that the ABA sweep runs over;
- **report bodies**: dynamics bodies plus any ``dont_collapse`` fixed links
  (e.g. Go1 feet) kept as distinct *contact-reporting* slots, mirroring how
  IsaacGym keeps such links addressable in its rigid-body/contact tensors.

Collision geometry is decomposed into spheres (sphere-vs-terrain is the
contact primitive, SURVEY.md §2.1 N2); each sphere knows both its dynamics
body (to apply forces) and its report body (to report them).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class RobotModel:
    name: str

    # --- dynamics tree (merged) -----------------------------------------
    nb: int                       # number of dynamics bodies (incl. base)
    body_names: Tuple[str, ...]   # [nb]
    parent: np.ndarray            # [nb] int32; parent[0] == -1

    # --- joints: one revolute joint per non-base body -------------------
    nv: int                       # number of actuated DOFs (= nb - 1)
    joint_names: Tuple[str, ...]  # [nv]
    E_tree: np.ndarray            # [nv,3,3] rotation parent->child frame
    p_tree: np.ndarray            # [nv,3] child frame origin in parent frame
    axis: np.ndarray              # [nv,3] joint axis in child frame
    dof_lower: np.ndarray         # [nv]
    dof_upper: np.ndarray         # [nv]
    dof_effort: np.ndarray        # [nv] torque limit
    dof_velocity: np.ndarray      # [nv] velocity limit
    dof_damping: np.ndarray       # [nv] passive viscous damping
    dof_friction: np.ndarray      # [nv] passive dry friction
    dof_armature: np.ndarray      # [nv]

    # --- mass properties per dynamics body ------------------------------
    mass: np.ndarray              # [nb]
    com: np.ndarray               # [nb,3] CoM in body frame
    inertia: np.ndarray           # [nb,3,3] rotational inertia about CoM

    # --- collision spheres ----------------------------------------------
    ng: int
    geom_body: np.ndarray         # [ng] int32, dynamics body index
    geom_report_body: np.ndarray  # [ng] int32, report body index
    geom_offset: np.ndarray       # [ng,3] sphere center in body frame
    geom_radius: np.ndarray       # [ng]

    # --- contact-report bodies ------------------------------------------
    nr: int
    report_body_names: Tuple[str, ...]  # [nr]
    # source link names merged into each report body (for name matching)
    report_body_sources: Tuple[Tuple[str, ...], ...]

    # -------------------------------------------------------------------
    def match_report_bodies(self, substrings: Sequence[str]) -> List[int]:
        """Report-body indices whose merged/source names contain any of the
        given substrings (reference `_create_envs` name matching,
        legged_robot.py:1201-1207)."""
        out = []
        for i, (name, sources) in enumerate(
            zip(self.report_body_names, self.report_body_sources)
        ):
            pool = (name,) + sources
            if any(s in n for s in substrings for n in pool):
                out.append(i)
        return out

    def total_mass(self) -> float:
        return float(np.sum(self.mass))

    def dof_index(self, joint_name: str) -> int:
        return self.joint_names.index(joint_name)

    def validate(self) -> None:
        assert self.parent.shape == (self.nb,)
        assert self.parent[0] == -1
        assert np.all(self.parent[1:] < np.arange(1, self.nb)), \
            "bodies must be topologically ordered (parent before child)"
        assert self.nv == self.nb - 1
        assert self.E_tree.shape == (self.nv, 3, 3)
        assert self.geom_offset.shape == (self.ng, 3)
        assert self.geom_body.max(initial=-1) < self.nb
        assert self.geom_report_body.max(initial=-1) < self.nr
        # axes normalized
        np.testing.assert_allclose(
            np.linalg.norm(self.axis, axis=-1), 1.0, atol=1e-6)
