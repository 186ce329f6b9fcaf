"""Output record of one physics step (port of ``ops/physics.py::StepOutput``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .dynamics import SimState


class StepOutput(NamedTuple):
    state: SimState
    contact_report: torch.Tensor  # [N,nr,3] world net contact force per report body
    geom_pos: torch.Tensor        # [N,ng,3] world sphere centers (pre-step)
