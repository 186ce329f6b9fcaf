"""URDF -> :class:`RobotModel` (host-side, NumPy, init-time only).

Replaces IsaacGym's native URDF importer (``gym.load_asset`` with
``AssetOptions.collapse_fixed_joints`` etc., reference
legged_robot.py:1175-1198). Semantics reproduced:

- fixed joints are collapsed into their parent (mass properties compounded,
  collision geometry re-parented) EXCEPT joints marked ``dont_collapse="true"``
  — those links stay addressable as contact-report bodies (the Go1 feet);
- joint limits/effort/velocity come from ``<limit>``, passive damping/friction
  from ``<dynamics>``;
- ``armature`` is an asset-level option added to every DOF.

Collision geometry is decomposed into spheres:

- ``sphere`` -> itself;
- ``box`` -> 4 corner spheres spanning the two longest half-extents, radius =
  smallest half-extent (degenerates to 2/1 spheres for rods/cubes);
- ``cylinder`` -> cap-center spheres of the cylinder radius;
- ``mesh`` -> a small lookup table of hand-measured sphere sets for the
  mini-cheetah meshes (the only meshes in the supported assets); unknown
  meshes are skipped with a warning.
"""

from __future__ import annotations

import math
import os
import warnings
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from .robot_model import RobotModel

# Hand-measured sphere decompositions for mesh collision shapes, expressed in
# the LINK frame (geom origin/rpy ignored). Keyed by mesh basename.
_MESH_SPHERES: Dict[str, List[Tuple[Tuple[float, float, float], float]]] = {
    # mini cheetah abductor housing: ~9 cm pod around the hip axis
    "mini_abad.obj": [((0.0, 0.0, 0.0), 0.046)],
    # mini cheetah lower link: rod from knee (z=0) to foot (z=-0.21);
    # foot sphere matches the real robot's ~2 cm foot ball
    "mini_lower_link.obj": [((0.0, 0.0, -0.21), 0.0175),
                            ((0.0, 0.0, -0.105), 0.012)],
}

# Hull-accurate alternative (AssetCfg.mesh_sphere_fit="hull"): sphere chains
# fitted to the actual collision mesh vertices, in the link frame (i.e. with
# the URDF collision origin applied — mini_cheetah.urdf:176-181 mounts
# mini_lower_link.obj with rpy="0 pi 0"). PhysX collides the convex hull of
# this mesh, whose foot ball bottoms out at link z=-0.1933 — the legacy
# table's tip sphere (bottom -0.2275) makes the leg 3.4 cm too long — and
# whose knee end is a ~4.2 cm-wide clevis knob the legacy table leaves
# uncovered (EXPERIMENTS.md §14).
_MESH_SPHERES_HULL: Dict[str, List[Tuple[Tuple[float, float, float], float]]] = {
    "mini_abad.obj": _MESH_SPHERES["mini_abad.obj"],
    "mini_lower_link.obj": [
        ((0.0, 0.0, -0.179), 0.014),   # foot ball (hull bottom -0.193)
        ((0.0, 0.0, -0.145), 0.007),   # shin
        ((0.0, 0.0, -0.100), 0.008),   # shin
        ((0.0, 0.0, -0.055), 0.010),   # shin
        ((0.0, 0.0, 0.000), 0.021),    # knee clevis knob
    ],
}

_MESH_FITS = {"legacy": _MESH_SPHERES, "hull": _MESH_SPHERES_HULL}


def _vec(s: Optional[str], default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if s is None:
        return np.asarray(default, dtype=np.float64)
    return np.asarray([float(x) for x in s.split()], dtype=np.float64)


def _rpy_to_mat(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


class _Link:
    def __init__(self, name: str):
        self.name = name
        self.mass = 0.0
        self.com = np.zeros(3)
        self.inertia = np.zeros((3, 3))
        # spheres: (offset[3], radius, source_link_name)
        self.spheres: List[Tuple[np.ndarray, float, str]] = []


def _parse_inertial(link_el) -> Tuple[float, np.ndarray, np.ndarray]:
    iel = link_el.find("inertial")
    if iel is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    mass = float(iel.find("mass").get("value"))
    org = iel.find("origin")
    com = _vec(org.get("xyz") if org is not None else None)
    R = _rpy_to_mat(_vec(org.get("rpy") if org is not None else None))
    ie = iel.find("inertia")
    ixx, iyy, izz = (float(ie.get(k)) for k in ("ixx", "iyy", "izz"))
    ixy = float(ie.get("ixy", 0.0))
    ixz = float(ie.get("ixz", 0.0))
    iyz = float(ie.get("iyz", 0.0))
    I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    # rotate inertia from inertial frame into link frame
    I = R @ I @ R.T
    return mass, com, I


def _geom_spheres(col_el, link_name: str,
                  mesh_spheres: Dict[str, List[Tuple[Tuple[float, float,
                                                           float], float]]]
                  = _MESH_SPHERES
                  ) -> List[Tuple[np.ndarray, float, str]]:
    org = col_el.find("origin")
    off = _vec(org.get("xyz") if org is not None else None)
    R = _rpy_to_mat(_vec(org.get("rpy") if org is not None else None))
    g = col_el.find("geometry")
    out: List[Tuple[np.ndarray, float, str]] = []
    for ge in g:
        if ge.tag == "sphere":
            out.append((off.copy(), float(ge.get("radius")), link_name))
        elif ge.tag == "box":
            # grid of spheres (radius = smallest half-extent) spanning the
            # two larger axes, dense enough that every point of the box
            # surface is within ~one radius of a sphere. A sparse corner
            # set under-covers plate-like boxes: the mini-cheetah thigh
            # (0.17x0.015x0.03) then never touched the ground when the
            # robot splayed flat or knelt — removing the contact
            # termination PhysX delivers, and RL found the exploit
            # (policies converged to lying spread-eagled; round-2 notes).
            half = _vec(ge.get("size")) / 2.0
            order = np.argsort(-half)          # longest axes first
            a, b = order[0], order[1]
            # rod/plate (one dominant axis): a single row of spheres with
            # the MIDDLE half-extent as radius — matches the box edge the
            # ground meets when a leg kneels, slightly overcovers the thin
            # face; near-isotropic boxes: a grid at the smallest extent
            plate = half[order[0]] >= 3.0 * half[order[1]]
            r = float(half[order[1]] if plate else half[order[2]])

            def _centers(h):
                span = max(h - r, 0.0)
                n = int(np.clip(np.ceil(h / max(r, 1e-6)), 1, 6))
                if n == 1:
                    return [0.0]
                return list(np.linspace(-span, span, n))

            seen = set()
            for ca in _centers(half[a]):
                for cb in ([0.0] if plate else _centers(half[b])):
                    local = np.zeros(3)
                    local[a] = ca
                    local[b] = cb
                    key = tuple(np.round(local, 9))
                    if key in seen:
                        continue
                    seen.add(key)
                    out.append((off + R @ local, r, link_name))
        elif ge.tag == "cylinder":
            r = float(ge.get("radius"))
            half_l = float(ge.get("length")) / 2.0
            dz = max(half_l - r, 0.0)
            ends = {tuple(np.round(off + R @ np.array([0, 0, s * dz]), 9))
                    for s in (-1.0, 1.0)}
            for e in ends:
                out.append((np.asarray(e), r, link_name))
        elif ge.tag == "mesh":
            base = os.path.basename(ge.get("filename", ""))
            if base in mesh_spheres:
                for local, r in mesh_spheres[base]:
                    out.append((np.asarray(local, dtype=np.float64), r, link_name))
            else:
                warnings.warn(f"urdf: no sphere decomposition for mesh {base!r}; skipped")
    return out


def _merge_inertia(m1, c1, I1, m2, c2, I2):
    """Combine two rigid bodies expressed in the same frame."""
    m = m1 + m2
    if m <= 0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    c = (m1 * c1 + m2 * c2) / m

    def parallel(mi, ci, Ii):
        d = ci - c
        return Ii + mi * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    return m, c, parallel(m1, c1, I1) + parallel(m2, c2, I2)


def load_urdf(path: str, armature: float = 0.0,
              base_link: Optional[str] = None,
              mesh_sphere_fit: str = "legacy") -> RobotModel:
    """Parse a URDF into a :class:`RobotModel`.

    Args:
      path: URDF file path.
      armature: added rotor inertia per DOF (AssetOptions.armature analogue).
      base_link: root link override; default = the link that is nobody's child.
      mesh_sphere_fit: "legacy" (round 1-3 hand-measured spheres) or "hull"
        (chains fitted to the collision-mesh hull; EXPERIMENTS.md §14).
    """
    root = ET.parse(path).getroot()
    name = root.get("name", os.path.splitext(os.path.basename(path))[0])
    mesh_spheres = _MESH_FITS[mesh_sphere_fit]

    links: Dict[str, _Link] = {}
    for lel in root.findall("link"):
        L = _Link(lel.get("name"))
        L.mass, L.com, L.inertia = _parse_inertial(lel)
        for cel in lel.findall("collision"):
            L.spheres.extend(_geom_spheres(cel, L.name, mesh_spheres))
        links[L.name] = L

    joints = []
    children = set()
    for jel in root.findall("joint"):
        jtype = jel.get("type")
        org = jel.find("origin")
        jd = dict(
            name=jel.get("name"),
            type=jtype,
            parent=jel.find("parent").get("link"),
            child=jel.find("child").get("link"),
            xyz=_vec(org.get("xyz") if org is not None else None),
            R=_rpy_to_mat(_vec(org.get("rpy") if org is not None else None)),
            dont_collapse=jel.get("dont_collapse", "false").lower() == "true",
        )
        ax = jel.find("axis")
        jd["axis"] = _vec(ax.get("xyz") if ax is not None else "1 0 0")
        lim = jel.find("limit")
        jd["lower"] = float(lim.get("lower", "0")) if lim is not None else 0.0
        jd["upper"] = float(lim.get("upper", "0")) if lim is not None else 0.0
        jd["effort"] = float(lim.get("effort", "0")) if lim is not None else 0.0
        jd["velocity"] = float(lim.get("velocity", "0")) if lim is not None else 0.0
        dyn = jel.find("dynamics")
        jd["damping"] = float(dyn.get("damping", "0")) if dyn is not None else 0.0
        jd["friction"] = float(dyn.get("friction", "0")) if dyn is not None else 0.0
        joints.append(jd)
        children.add(jd["child"])

    if base_link is None:
        roots = [n for n in links if n not in children]
        assert len(roots) == 1, f"expected a unique root link, got {roots}"
        base_link = roots[0]

    child_joints: Dict[str, List[dict]] = {}
    for jd in joints:
        child_joints.setdefault(jd["parent"], []).append(jd)

    # ---- build merged dynamics tree (DFS in URDF declaration order) ----
    body_names: List[str] = []
    parent_idx: List[int] = []
    body_links: List[_Link] = []          # accumulated merged link per body
    joint_meta: List[dict] = []           # per non-base body
    report_names: List[str] = []
    report_sources: List[List[str]] = []
    # spheres with (dyn_body, report_body, offset, radius)
    spheres: List[Tuple[int, int, np.ndarray, float]] = []

    def add_report_body(name_: str) -> int:
        report_names.append(name_)
        report_sources.append([name_])
        return len(report_names) - 1

    def absorb(body_i: int, report_i: int, link: _Link,
               E: np.ndarray, p: np.ndarray, collapse_into_report: bool):
        """Fold `link` (frame at rotation E / offset p relative to the body
        frame, i.e. x_body = E @ x_link + p) into dynamics body `body_i`."""
        B = body_links[body_i]
        com_b = E @ link.com + p
        I_b = E @ link.inertia @ E.T
        B.mass, B.com, B.inertia = _merge_inertia(
            B.mass, B.com, B.inertia, link.mass, com_b, I_b)
        rep = report_i
        if not collapse_into_report:
            rep = add_report_body(link.name)
        else:
            report_sources[report_i].append(link.name)
        for off, r, src in link.spheres:
            spheres.append((body_i, rep, E @ off + p, r))
        return rep

    def walk(link_name: str, body_i: int, report_i: int,
             E: np.ndarray, p: np.ndarray):
        """Recurse over children of `link_name`, whose frame sits at (E, p)
        relative to dynamics body `body_i`'s frame."""
        for jd in child_joints.get(link_name, []):
            child = links[jd["child"]]
            if jd["type"] in ("fixed",):
                Ec = E @ jd["R"]
                pc = E @ jd["xyz"] + p
                rep = absorb(body_i, report_i, child, Ec, pc,
                             collapse_into_report=not jd["dont_collapse"])
                walk(child.name, body_i, rep, Ec, pc)
            elif jd["type"] in ("revolute", "continuous"):
                # new dynamics body; its frame == URDF child link frame
                new_i = len(body_names)
                body_names.append(child.name)
                parent_idx.append(body_i)
                nl = _Link(child.name)
                nl.mass, nl.com, nl.inertia = child.mass, child.com, child.inertia
                body_links.append(nl)
                new_rep = add_report_body(child.name)
                for off, r, src in child.spheres:
                    spheres.append((new_i, new_rep, off.copy(), r))
                # joint placement: child frame at (E @ R, E @ xyz + p) in parent BODY frame
                joint_meta.append(dict(
                    name=jd["name"],
                    E=(E @ jd["R"]),
                    p=(E @ jd["xyz"] + p),
                    axis=jd["axis"] / np.linalg.norm(jd["axis"]),
                    lower=jd["lower"], upper=jd["upper"],
                    effort=jd["effort"], velocity=jd["velocity"],
                    damping=jd["damping"], friction=jd["friction"],
                ))
                walk(child.name, new_i, new_rep, np.eye(3), np.zeros(3))
            else:
                raise NotImplementedError(f"joint type {jd['type']!r}")

    base = links[base_link]
    body_names.append(base.name)
    parent_idx.append(-1)
    b0 = _Link(base.name)
    b0.mass, b0.com, b0.inertia = base.mass, base.com, base.inertia
    body_links.append(b0)
    rep0 = add_report_body(base.name)
    for off, r, src in base.spheres:
        spheres.append((0, rep0, off.copy(), r))
    walk(base.name, 0, rep0, np.eye(3), np.zeros(3))

    nb = len(body_names)
    nv = nb - 1
    ng = len(spheres)

    model = RobotModel(
        name=name,
        nb=nb,
        body_names=tuple(body_names),
        parent=np.asarray(parent_idx, dtype=np.int32),
        nv=nv,
        joint_names=tuple(j["name"] for j in joint_meta),
        E_tree=np.stack([j["E"] for j in joint_meta]).astype(np.float64),
        p_tree=np.stack([j["p"] for j in joint_meta]).astype(np.float64),
        axis=np.stack([j["axis"] for j in joint_meta]).astype(np.float64),
        dof_lower=np.asarray([j["lower"] for j in joint_meta]),
        dof_upper=np.asarray([j["upper"] for j in joint_meta]),
        dof_effort=np.asarray([j["effort"] for j in joint_meta]),
        dof_velocity=np.asarray([j["velocity"] for j in joint_meta]),
        dof_damping=np.asarray([j["damping"] for j in joint_meta]),
        dof_friction=np.asarray([j["friction"] for j in joint_meta]),
        dof_armature=np.full(nv, armature, dtype=np.float64),
        mass=np.asarray([b.mass for b in body_links]),
        com=np.stack([b.com for b in body_links]),
        inertia=np.stack([b.inertia for b in body_links]),
        ng=ng,
        geom_body=np.asarray([s[0] for s in spheres], dtype=np.int32),
        geom_report_body=np.asarray([s[1] for s in spheres], dtype=np.int32),
        geom_offset=(np.stack([s[2] for s in spheres])
                     if ng else np.zeros((0, 3))),
        geom_radius=np.asarray([s[3] for s in spheres]),
        nr=len(report_names),
        report_body_names=tuple(report_names),
        report_body_sources=tuple(tuple(s) for s in report_sources),
    )
    model.validate()
    return model
