"""Conversion between the JAX package's pytrees (as NumPy) and the port's
types, so that both packages can start from the same weights and the same
state, and the port can write checkpoints in the JAX layout.

Works on plain NumPy data and attribute access only: it does not import the
JAX package. The JAX-layout named tuples are the stand-ins of
:mod:`.utils.checkpoint`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from .envs.curriculum import CurriculumState
from .envs.hlp import HLPState
from .envs.legged_robot import DRState, EnvState
from .learn.ppo import PPOArgs, PPOState, init_ppo_state
from .models.networks import ActorCritic
from .ops.dynamics import SimState
from .utils import checkpoint as J

_DENSE = re.compile(r"Dense_(\d+)$")
_LAYER = re.compile(r"^(\w+)\.layers\.(\d+)\.(weight|bias)$")


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


def _flax_path(name: str):
    """State-dict name -> (module, Dense_i, leaf) of the Flax tree, or
    ("std",) for the std."""
    if name == "std":
        return ("std",)
    m = _LAYER.match(name)
    if m is None:
        raise KeyError(f"unexpected parameter {name}")
    return (m.group(1), f"Dense_{m.group(2)}",
            "kernel" if m.group(3) == "weight" else "bias")


def _to_flax_leaf(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy().astype(np.float32)
    return a.T.copy() if name.endswith(".weight") else a


def params_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_flax`: a state dict -> the Flax
    ``params`` tree (kernels [in, out]), NumPy float32 leaves."""
    out: Dict[str, Any] = {}
    for name, t in state_dict.items():
        path = _flax_path(name)
        if path == ("std",):
            out["std"] = _to_flax_leaf(name, t)
            continue
        module, dense, leaf = path
        out.setdefault(module, {}).setdefault(dense, {})[leaf] = \
            _to_flax_leaf(name, t)
    return out


def _flax_leaf(tree: Dict[str, Any], name: str) -> np.ndarray:
    node = tree
    for k in _flax_path(name):
        node = node[k]
    return np.asarray(node)


def _adam_of(opt_state) -> "J.ScaleByAdamState":
    """The one ScaleByAdamState inside an optax state, at whatever depth
    the chain nests it."""
    found = []

    def walk(x):
        if isinstance(x, J.ScaleByAdamState):
            found.append(x)
        elif isinstance(x, tuple):
            for y in x:
                walk(y)
    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one Adam state, found {len(found)}")
    return found[0]


def _names(ac: ActorCritic, opt: Optional[torch.optim.Adam]):
    if opt is None:
        return []
    by_id = {id(p): n for n, p in ac.named_parameters()}
    return [(by_id[id(p)], p) for g in opt.param_groups for p in g["params"]]


def _load_adam(ac: ActorCritic, opt: Optional[torch.optim.Adam], adam):
    """optax Adam (count, mu, nu over the whole Flax tree) -> the torch
    Adam of one parameter group (step, exp_avg, exp_avg_sq)."""
    if opt is None:
        return
    count = float(np.asarray(adam.count))
    for name, p in _names(ac, opt):
        opt.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.tensor(
                _to_torch_layout(name, _flax_leaf(adam.mu["params"], name)),
                device=p.device),
            "exp_avg_sq": torch.tensor(
                _to_torch_layout(name, _flax_leaf(adam.nu["params"], name)),
                device=p.device),
        }


def _to_torch_layout(name: str, a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float32)
    return a.T.copy() if name.endswith(".weight") else a


def ppo_state_from_jax(state, ac: ActorCritic, ppo_args: PPOArgs
                       ) -> PPOState:
    """A JAX ``PPOState`` (NumPy leaves) -> the port's: its params into
    ``ac`` (in place), each optax Adam's ``count``/``mu``/``nu`` into its
    ``torch.optim.Adam``'s ``step``/``exp_avg``/``exp_avg_sq``, and the
    carried learning rate."""
    ac.load_state_dict(params_from_flax(state.params["params"]))
    ps = init_ppo_state(ac, ppo_args)
    _load_adam(ac, ps.opt, _adam_of(state.opt_state))
    _load_adam(ac, ps.adapt_opt, _adam_of(state.adapt_opt_state))
    lr = float(np.float32(np.asarray(state.lr)))
    for g in ps.opt.param_groups:
        g["lr"] = lr
    return ps._replace(lr=lr)


def _adam_to_jax(ac: ActorCritic, opt: Optional[torch.optim.Adam]):
    """The torch Adam of one group -> optax's ScaleByAdamState over the
    whole tree (zeros off the group, as optax keeps them)."""
    sd = ac.state_dict()
    mu = {k: torch.zeros_like(v) for k, v in sd.items()}
    nu = {k: torch.zeros_like(v) for k, v in sd.items()}
    count = 0
    for name, p in _names(ac, opt):
        st = opt.state.get(p)
        if not st:
            continue
        count = int(st["step"])
        mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
    return J.ScaleByAdamState(count=np.int32(count),
                              mu={"params": params_to_flax(mu)},
                              nu={"params": params_to_flax(nu)})


def ppo_state_to_jax(ac: ActorCritic, state: PPOState) -> "J.PPOState":
    """The port's PPO state -> a JAX ``PPOState`` of NumPy leaves, with
    the optax chains' nesting: ``clip_by_global_norm`` + ``adam`` for the
    policy, ``adam`` for the adaptation module."""
    return J.PPOState(
        params={"params": params_to_flax(ac.state_dict())},
        opt_state=(J.EmptyState(),
                   (_adam_to_jax(ac, state.opt), J.EmptyState())),
        adapt_opt_state=(_adam_to_jax(ac, state.adapt_opt), J.EmptyState()),
        lr=np.float32(state.lr))


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


def hlp_state_from_jax(state, device="cuda") -> HLPState:
    """A JAX ``HLPState`` (NumPy leaves) -> :class:`..envs.hlp.HLPState`;
    the low level through :func:`env_state_from_jax`, the key dropped."""
    fields = {}
    for f in HLPState._fields:
        v = getattr(state, f)
        if f == "ll":
            fields[f] = env_state_from_jax(v, device)
        elif f == "episode_sums":
            fields[f] = {k: _t(a, device) for k, a in v.items()}
        else:
            fields[f] = _t(v, device)
    return HLPState(**fields)


def state_from_jax(state, device="cuda"):
    """An env state of either kind (low level or HLP) -> the port's."""
    if isinstance(state, J.HLPState):
        return hlp_state_from_jax(state, device)
    return env_state_from_jax(state, device)


_INT32 = ("env_command_bins", "episode_length", "terrain_levels",
          "terrain_types", "common_step_counter")


def _np(name, x):
    if isinstance(x, dict):
        return {k: _np(k, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        tp = getattr(J, type(x).__name__)
        return tp(**{f: _np(f, getattr(x, f)) for f in x._fields})
    a = x.detach().cpu().numpy()
    return a.astype(np.int32) if name in _INT32 else a


def state_to_jax(state):
    """The port's env state (low level or HLP) -> the JAX package's named
    tuples of NumPy leaves, each with a zero PRNG key."""
    key = np.zeros(2, np.uint32)
    if isinstance(state, HLPState):
        d = {f: _np(f, getattr(state, f)) for f in HLPState._fields
             if f != "ll"}
        return J.HLPState(ll=state_to_jax(state.ll), key=key, **d)
    d = {f: _np(f, getattr(state, f)) for f in EnvState._fields}
    return J.EnvState(key=key, **d)
