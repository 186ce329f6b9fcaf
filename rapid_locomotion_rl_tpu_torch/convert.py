"""Conversion of the JAX package's pytrees (as NumPy) into the port's types,
so that both packages can start from the same weights and the same state.

Works on plain NumPy data and attribute access only: it does not import the
JAX package.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from .envs.curriculum import CurriculumState
from .envs.legged_robot import DRState, EnvState
from .ops.dynamics import SimState

_DENSE = re.compile(r"Dense_(\d+)$")


def params_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``ActorCritic`` params (``tree["params"]`` of a checkpoint) ->
    a state dict of :class:`..models.networks.ActorCritic`. Flax ``Dense``
    kernels are [in, out]; ``nn.Linear.weight`` is [out, in]."""
    out: Dict[str, torch.Tensor] = {}
    for module, sub in params.items():
        if module == "std":
            out["std"] = torch.tensor(np.asarray(sub), dtype=torch.float32)
            continue
        for dense, leaves in sub.items():
            m = _DENSE.match(dense)
            if m is None:
                raise KeyError(f"unexpected Flax module {module}/{dense}")
            i = int(m.group(1))
            out[f"{module}.layers.{i}.weight"] = torch.tensor(
                np.asarray(leaves["kernel"]).T.copy(), dtype=torch.float32)
            out[f"{module}.layers.{i}.bias"] = torch.tensor(
                np.asarray(leaves["bias"]), dtype=torch.float32)
    return out


def _t(x, device):
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def _named(tp, src, device):
    return tp(**{f: _t(getattr(src, f), device) for f in tp._fields})


def env_state_from_jax(state, device="cuda") -> EnvState:
    """A JAX ``EnvState`` whose leaves are NumPy arrays -> :class:`EnvState`.
    The JAX PRNG key is dropped: the port draws through a Sampler."""
    fields = {}
    for f in EnvState._fields:
        v = getattr(state, f)
        if f == "sim":
            fields[f] = _named(SimState, v, device)
        elif f == "dr":
            fields[f] = _named(DRState, v, device)
        elif f == "curriculum":
            fields[f] = _named(CurriculumState, v, device)
        elif f in ("episode_sums", "command_sums"):
            fields[f] = {k: _t(a, device) for k, a in v.items()}
        elif f == "env_command_bins":
            fields[f] = _t(v, device).long()
        else:
            fields[f] = _t(v, device)
    return EnvState(**fields)
