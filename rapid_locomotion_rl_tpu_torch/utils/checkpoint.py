"""Checkpoints of the full training state as plain NumPy pytrees, in the
JAX package's layout.

A train-state file is a dict ``{"ppo_state", "env_state", "key",
"iteration", "tot_timesteps"}`` whose leaves are NumPy arrays. Its named
tuples are the JAX package's (``PPOState``, ``HLPState``, ``EnvState``,
``SimState``, ``DRState``, ``CurriculumState``) and optax's Adam states
(``EmptyState``, ``ScaleByAdamState``), with the same fields in the same
order. The port does not import those packages: :func:`load_pytree` maps
each of their class names to a stand-in defined here, and the port writes
its own checkpoints with the same stand-ins (:func:`save_pytree`), so one
loader reads both. :mod:`..convert` turns them into the port's state.

The pickles were written under numpy 2, whose arrays pickle as
``numpy._core.multiarray``; under an older numpy that module is
``numpy.core.multiarray``, so the loader maps the name.
Unpickling can run code: load only files this project wrote.

:func:`export_student_policy` writes the deployment policy (the student:
adaptation module and actor body) as a ``torch.export`` program beside
its params, the port's counterpart of the JAX package's StableHLO file.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from collections import namedtuple
from typing import Any

import numpy as np
import torch

# stand-ins for the classes that the JAX package's checkpoints name
PPOState = namedtuple("PPOState",
                      ("params", "opt_state", "adapt_opt_state", "lr"))
HLPState = namedtuple("HLPState", (
    "ll", "actions", "last_actions", "episode_length", "last_pos",
    "dist_travelled", "goal_position", "episode_sums", "obs",
    "privileged_obs", "obs_history", "key"))
EnvState = namedtuple("EnvState", (
    "sim", "dr", "commands", "env_command_bins", "actions", "last_actions",
    "last_dof_vel", "torques", "joint_pos_target", "episode_length",
    "reset_buf", "time_out_buf", "feet_air_time", "last_contacts",
    "contact_report", "measured_heights", "episode_sums", "command_sums",
    "curriculum", "env_origins", "terrain_levels", "terrain_types", "obs",
    "privileged_obs", "obs_history", "key", "common_step_counter"))
SimState = namedtuple("SimState", ("base_pos", "base_quat", "base_lin_vel",
                                   "base_ang_vel", "q", "qd"))
DRState = namedtuple("DRState", (
    "friction", "restitution", "payloads", "com_displacements",
    "motor_strengths", "Kp_factors", "Kd_factors"))
CurriculumState = namedtuple("CurriculumState", (
    "weights", "episode_reward_lin", "episode_reward_ang",
    "episode_lin_vel_raw", "episode_ang_vel_raw", "episode_duration"))
EmptyState = namedtuple("EmptyState", ())
ScaleByAdamState = namedtuple("ScaleByAdamState", ("count", "mu", "nu"))

_STAND_INS = {
    ("rapid_locomotion_rl_tpu.learn.ppo", "PPOState"): PPOState,
    ("rapid_locomotion_rl_tpu.envs.hlp", "HLPState"): HLPState,
    ("rapid_locomotion_rl_tpu.envs.legged_robot", "EnvState"): EnvState,
    ("rapid_locomotion_rl_tpu.envs.legged_robot", "DRState"): DRState,
    ("rapid_locomotion_rl_tpu.ops.dynamics", "SimState"): SimState,
    ("rapid_locomotion_rl_tpu.envs.curriculum", "CurriculumState"):
        CurriculumState,
    ("optax._src.base", "EmptyState"): EmptyState,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        hit = _STAND_INS.get((module, name))
        if hit is not None:
            return hit
        if module.startswith(("rapid_locomotion_rl_tpu.", "optax", "jax",
                              "flax")):
            raise pickle.UnpicklingError(
                f"no stand-in for {module}.{name} in the PyTorch port")
        if module.startswith("numpy._core") and not hasattr(np, "_core"):
            module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def load_pytree(path: str) -> Any:
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def save_pytree(tree: Any, path: str):
    """Pickle a NumPy pytree, through a temp file in the same directory so
    that a cut run never leaves half a checkpoint."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".pkl", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(tree, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class _Student(torch.nn.Module):
    """(obs, obs_history) -> the deterministic student action."""

    def __init__(self, ac):
        super().__init__()
        self.ac = ac

    def forward(self, obs, obs_history):
        return self.ac.act_student(obs, obs_history)


def export_student_policy(ac, params, num_obs: int, num_hist: int,
                          path_prefix: str):
    """Serialize the deployment policy (obs, obs_history) -> actions.

    Writes ``<prefix>.params.pkl`` (``params``, the Flax-layout tree) and
    ``<prefix>.pt2``, a ``torch.export`` program of ``ac.act_student`` at
    shapes (1, num_obs) and (1, num_hist) on the module's device; load it
    with ``torch.export.load(path).module()``. A failed export raises."""
    save_pytree(params, path_prefix + ".params.pkl")
    dev = next(ac.parameters()).device
    args = (torch.zeros((1, num_obs), device=dev),
            torch.zeros((1, num_hist), device=dev))
    program = torch.export.export(_Student(ac), args)
    d = os.path.dirname(path_prefix) or "."
    fd, tmp = tempfile.mkstemp(suffix=".pt2", dir=d)
    os.close(fd)
    try:
        torch.export.save(program, tmp)
        os.replace(tmp, path_prefix + ".pt2")
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
