"""Named domain-randomization presets for evaluation sweeps (port of the
JAX package's ``learn/dr_eval.py``, on the port's :class:`..config.Cfg`).

Re-creates the reference DR_SETTINGS (reference
mini_gym_learn/eval_metrics/domain_randomization.py:4-148): each preset is a
function mutating a config copy, used to build evaluation envs at fixed or
randomized dynamics.
"""

from __future__ import annotations

from typing import Callable, Dict

from ..config import Cfg


def _base_set(cfg: Cfg) -> Cfg:
    c = cfg.copy()
    c.domain_rand.randomize_friction = True
    c.domain_rand.randomize_restitution = True
    c.domain_rand.randomize_base_mass = True
    c.domain_rand.randomize_com_displacement = True
    c.domain_rand.randomize_motor_strength = True
    return c


def rand_regular(cfg: Cfg) -> Cfg:
    """The training ranges (domain_randomization.py:16)."""
    return _base_set(cfg)


def rand_large(cfg: Cfg) -> Cfg:
    """Wider-than-training ranges (:37)."""
    c = _base_set(cfg)
    c.domain_rand.friction_range = [0.01, 6.0]
    c.domain_rand.added_mass_range = [-1.5, 4.0]
    c.domain_rand.com_displacement_range = [-0.15, 0.15]
    c.domain_rand.motor_strength_range = [0.8, 1.2]
    return c


def _static(cfg: Cfg, friction, payload, motor) -> Cfg:
    c = cfg.copy()
    for flag in ("randomize_friction", "randomize_restitution",
                 "randomize_base_mass", "randomize_com_displacement",
                 "randomize_motor_strength"):
        setattr(c.domain_rand, flag, False)
    # pin by collapsing the ranges
    c.domain_rand.randomize_friction = True
    c.domain_rand.friction_range = [friction, friction]
    c.domain_rand.randomize_base_mass = True
    c.domain_rand.added_mass_range = [payload, payload]
    c.domain_rand.randomize_motor_strength = True
    c.domain_rand.motor_strength_range = [motor, motor]
    return c


def static_low(cfg: Cfg) -> Cfg:
    """Easy dynamics: grippy, light, strong (:58)."""
    return _static(cfg, friction=1.0, payload=0.0, motor=1.1)


def static_medium(cfg: Cfg) -> Cfg:
    return _static(cfg, friction=0.6, payload=1.0, motor=1.0)


def static_high(cfg: Cfg) -> Cfg:
    """Hard dynamics: slippery, loaded, weak (:100)."""
    return _static(cfg, friction=0.1, payload=3.0, motor=0.9)


def only_base_mass(cfg: Cfg) -> Cfg:
    """(:120)"""
    c = cfg.copy()
    for flag in ("randomize_friction", "randomize_restitution",
                 "randomize_com_displacement", "randomize_motor_strength"):
        setattr(c.domain_rand, flag, False)
    c.domain_rand.randomize_base_mass = True
    return c


DR_SETTINGS: Dict[str, Callable[[Cfg], Cfg]] = {
    "rand_regular": rand_regular,
    "rand_large": rand_large,
    "static_low": static_low,
    "static_medium": static_medium,
    "static_high": static_high,
    "only_base_mass": only_base_mass,
}
