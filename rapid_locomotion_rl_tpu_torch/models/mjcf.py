"""MJCF (MuJoCo XML) -> :class:`RobotModel` (host-side NumPy, init-time
only): the port's own copy of the JAX package's ``models/mjcf.py``.

The reference ships a Go1 MJCF beside the URDF
(resources/robots/go1/xml/go1.xml); this parser makes it loadable on the
same dynamics stack. Supported subset (what the shipped asset uses):
nested ``<body>`` trees with ``pos``/``quat``, hinge joints with
``axis``/``range``/defaults, ``<inertial>`` blocks, sphere/box/capsule
geoms (meshes skipped), ``<default>`` joint/motor classes, actuator
ctrlrange as the effort limit. Every joint's velocity limit is 100 rad/s.
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from .robot_model import RobotModel


def _vec(s: Optional[str], default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if s is None:
        return np.asarray(default, dtype=np.float64)
    return np.asarray([float(x) for x in s.split()], dtype=np.float64)


def _quat_to_mat(q_wxyz: np.ndarray) -> np.ndarray:
    w, x, y, z = q_wxyz
    n = math.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _body_frame(el) -> Tuple[np.ndarray, np.ndarray]:
    pos = _vec(el.get("pos"))
    if el.get("quat") is not None:
        R = _quat_to_mat(_vec(el.get("quat"), (1, 0, 0, 0)))
    elif el.get("euler") is not None:
        r, p, y = _vec(el.get("euler"))
        Rz = np.array([[math.cos(y), -math.sin(y), 0],
                       [math.sin(y), math.cos(y), 0], [0, 0, 1]])
        Ry = np.array([[math.cos(p), 0, math.sin(p)], [0, 1, 0],
                       [-math.sin(p), 0, math.cos(p)]])
        Rx = np.array([[1, 0, 0], [0, math.cos(r), -math.sin(r)],
                       [0, math.sin(r), math.cos(r)]])
        R = Rx @ Ry @ Rz  # mujoco euler = intrinsic xyz
    else:
        R = np.eye(3)
    return R, pos


def _parse_inertial(el) -> Tuple[float, np.ndarray, np.ndarray]:
    iel = el.find("inertial")
    if iel is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    mass = float(iel.get("mass"))
    com = _vec(iel.get("pos"))
    if iel.get("fullinertia") is not None:
        xx, yy, zz, xy, xz, yz = _vec(iel.get("fullinertia"),
                                      (0,) * 6)[:6]
        I = np.array([[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]])
    elif iel.get("diaginertia") is not None:
        I = np.diag(_vec(iel.get("diaginertia")))
        if iel.get("quat") is not None:
            R = _quat_to_mat(_vec(iel.get("quat"), (1, 0, 0, 0)))
            I = R @ I @ R.T
    else:
        I = np.zeros((3, 3))
    return mass, com, I


def _geom_spheres(gel, defaults) -> List[Tuple[np.ndarray, float]]:
    gtype = gel.get("type", defaults.get("geom_type", "sphere"))
    pos = _vec(gel.get("pos"))
    out = []
    if gtype == "sphere":
        out.append((pos, float(_vec(gel.get("size"), (0.02,))[0])))
    elif gtype == "capsule":
        size = _vec(gel.get("size"), (0.02,))
        r = float(size[0])
        if gel.get("fromto") is not None:
            ft = _vec(gel.get("fromto"), (0,) * 6)
            out.append((ft[:3], r))
            out.append((ft[3:6], r))
        else:
            half = float(size[1]) if size.shape[0] > 1 else 0.0
            out.append((pos + np.array([0, 0, half]), r))
            out.append((pos - np.array([0, 0, half]), r))
    elif gtype == "box":
        half = _vec(gel.get("size"))
        order = np.argsort(-half)
        r = float(half[order[2]])
        da = max(half[order[0]] - r, 0.0)
        db = max(half[order[1]] - r, 0.0)
        seen = set()
        for sa in (-1.0, 1.0):
            for sb in (-1.0, 1.0):
                local = np.zeros(3)
                local[order[0]] = sa * da
                local[order[1]] = sb * db
                key = tuple(np.round(local, 9))
                if key in seen:
                    continue
                seen.add(key)
                R, _ = _body_frame(gel)
                out.append((pos + R @ local, r))
    # meshes / planes skipped
    return out


def load_mjcf(path: str, armature: Optional[float] = None) -> RobotModel:
    import re
    with open(path) as f:
        text = f.read()
    # the reference's shipped go1.xml contains unquoted attribute values
    # (objtype=site); quote them so ElementTree accepts the file
    text = re.sub(r'=(?!["\'])([A-Za-z_][\w.\-]*)', r'="\1"', text)
    root = ET.fromstring(text)
    name = root.get("model", os.path.splitext(os.path.basename(path))[0])

    # defaults (joint damping/armature/frictionloss, motor ctrlrange)
    defaults: Dict[str, float] = {}
    dflt = root.find("default")
    if dflt is not None:
        j = dflt.find("joint")
        if j is not None:
            defaults["damping"] = float(j.get("damping", 0.0))
            defaults["armature"] = float(j.get("armature", 0.0))
            defaults["frictionloss"] = float(j.get("frictionloss", 0.0))
        m = dflt.find("motor")
        if m is not None and m.get("ctrlrange"):
            lo, hi = _vec(m.get("ctrlrange"), (0, 0))[:2]
            defaults["effort"] = max(abs(lo), abs(hi))

    body_names: List[str] = []
    parent_idx: List[int] = []
    masses: List[float] = []
    coms: List[np.ndarray] = []
    inertias: List[np.ndarray] = []
    joints: List[dict] = []
    spheres: List[Tuple[int, np.ndarray, float]] = []

    def walk(el, parent_body: int, E_acc: np.ndarray, p_acc: np.ndarray):
        """Recurse over <body> children. (E_acc, p_acc) = accumulated fixed
        transform from the parent dynamics body frame (for jointless
        bodies, which are merged)."""
        for bel in el.findall("body"):
            R, p = _body_frame(bel)
            E_b = E_acc @ R
            p_b = E_acc @ p + p_acc
            jel = bel.find("joint")
            free = bel.find("freejoint") is not None or (
                jel is not None and jel.get("type") == "free")
            if free or parent_body == -1:
                # root body
                i = len(body_names)
                assert i == 0, "only one free/root body supported"
                body_names.append(bel.get("name", "base"))
                parent_idx.append(-1)
                m, c, I = _parse_inertial(bel)
                masses.append(m)
                coms.append(c)
                inertias.append(I)
                for gel in bel.findall("geom"):
                    for off, r in _geom_spheres(gel, defaults):
                        spheres.append((i, off, r))
                walk(bel, i, np.eye(3), np.zeros(3))
            elif jel is not None and jel.get("type", "hinge") == "hinge":
                i = len(body_names)
                body_names.append(bel.get("name", f"body{i}"))
                parent_idx.append(parent_body)
                m, c, I = _parse_inertial(bel)
                masses.append(m)
                coms.append(c)
                inertias.append(I)
                rng = _vec(jel.get("range"), (0.0, 0.0))[:2]
                joints.append(dict(
                    name=jel.get("name", f"joint{i}"),
                    E=E_b, p=p_b,
                    axis=_vec(jel.get("axis"), (0, 0, 1)),
                    lower=float(rng[0]), upper=float(rng[1]),
                    effort=defaults.get("effort", 33.5),
                    velocity=100.0,
                    damping=float(jel.get("damping",
                                          defaults.get("damping", 0.0))),
                    friction=float(jel.get("frictionloss",
                                           defaults.get("frictionloss", 0.0))),
                    armature=float(jel.get("armature",
                                           defaults.get("armature", 0.0))),
                ))
                for gel in bel.findall("geom"):
                    for off, r in _geom_spheres(gel, defaults):
                        spheres.append((i, off, r))
                walk(bel, i, np.eye(3), np.zeros(3))
            else:
                # jointless body: merge into parent
                m, c, I = _parse_inertial(bel)
                if parent_body >= 0 and m > 0:
                    from .urdf import _merge_inertia
                    com_p = E_b @ c + p_b
                    I_p = E_b @ I @ E_b.T
                    (masses[parent_body], coms[parent_body],
                     inertias[parent_body]) = _merge_inertia(
                        masses[parent_body], coms[parent_body],
                        inertias[parent_body], m, com_p, I_p)
                for gel in bel.findall("geom"):
                    for off, r in _geom_spheres(gel, defaults):
                        spheres.append((parent_body, E_b @ off + p_b, r))
                walk(bel, parent_body, E_b, p_b)

    world = root.find("worldbody")
    walk(world, -1, np.eye(3), np.zeros(3))

    nb = len(body_names)
    nv = nb - 1
    ng = len(spheres)
    arm = armature if armature is not None else None

    model = RobotModel(
        name=name,
        nb=nb,
        body_names=tuple(body_names),
        parent=np.asarray(parent_idx, dtype=np.int32),
        nv=nv,
        joint_names=tuple(j["name"] for j in joints),
        E_tree=np.stack([j["E"] for j in joints]),
        p_tree=np.stack([j["p"] for j in joints]),
        axis=np.stack([j["axis"] / np.linalg.norm(j["axis"])
                       for j in joints]),
        dof_lower=np.asarray([j["lower"] for j in joints]),
        dof_upper=np.asarray([j["upper"] for j in joints]),
        dof_effort=np.asarray([j["effort"] for j in joints]),
        dof_velocity=np.asarray([j["velocity"] for j in joints]),
        dof_damping=np.asarray([j["damping"] for j in joints]),
        dof_friction=np.asarray([j["friction"] for j in joints]),
        dof_armature=(np.full(nv, arm) if arm is not None
                      else np.asarray([j["armature"] for j in joints])),
        mass=np.asarray(masses),
        com=np.stack(coms),
        inertia=np.stack(inertias),
        ng=ng,
        geom_body=np.asarray([s[0] for s in spheres], dtype=np.int32),
        geom_report_body=np.asarray([s[0] for s in spheres], dtype=np.int32),
        geom_offset=(np.stack([s[1] for s in spheres])
                     if ng else np.zeros((0, 3))),
        geom_radius=np.asarray([s[2] for s in spheres]),
        nr=nb,
        report_body_names=tuple(body_names),
        report_body_sources=tuple((n,) for n in body_names),
    )
    model.validate()
    return model
