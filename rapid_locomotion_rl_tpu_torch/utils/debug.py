"""Numerics debugging and profiling hooks (port of the JAX package's
``utils/debug.py``).

- :func:`checked_step` wraps ``env.step`` and returns all-finite flags for
  every floating field of its outputs, in place of JAX's ``checkify``
  (eager PyTorch has no op-level float checks to compile in);
- :func:`state_health` gives a cheap all-finite / magnitude summary of a
  live state;
- :func:`nan_env_mask` marks the envs whose sim state is not finite;
- :func:`trace_iterations` records a ``torch.profiler`` trace of n train
  iterations as a Chrome trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Tuple

import torch


def _float_leaves(tree: Any, prefix: str) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every floating tensor in nested named tuples,
    dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)] if tree.is_floating_point() else []
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return []
    return [leaf for k, v in items
            for leaf in _float_leaves(v, f"{prefix}/{k}" if prefix else
                                      str(k))]


def checked_step(env) -> Callable:
    """env.step with float checks: ``fn(state, actions, sampler)`` returns
    ``(errors, (state, result))``, where ``errors`` maps each floating
    field of the new state and of the step result (``state/sim/q``,
    ``result/rew``, ...) to a 0-dim bool tensor, True where it is all
    finite. The flags stay on the device; reading them syncs."""
    def step(state, actions, sampler):
        new_state, result = env.step(state, actions, sampler)
        errors = {k: torch.isfinite(v).all() for k, v in
                  _float_leaves(new_state, "state")
                  + _float_leaves(result, "result")}
        return errors, (new_state, result)
    return step


def state_health(state: Any) -> Dict[str, torch.Tensor]:
    """All-finite flags and max magnitudes per top-level state field."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in zip(state._fields, state):
        leaves = [x for _, x in _float_leaves(sub, name) if x.numel()]
        if not leaves:
            continue
        out[f"{name}/finite"] = torch.stack(
            [torch.isfinite(x).all() for x in leaves]).all()
        out[f"{name}/max_abs"] = torch.stack(
            [x.abs().max() for x in leaves]).max()
    return out


def nan_env_mask(state) -> torch.Tensor:
    """[N] bool: envs whose sim state contains non-finite values."""
    flags = [torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)
             for x in state.sim]
    return ~torch.stack(flags, dim=0).all(dim=0)


def trace_iterations(train_iter: Callable, carry_args: tuple, n: int,
                     logdir: str = "build/torch-trace"):
    """Profile n calls of ``train_iter(*carry_args)`` (CPU and, when a
    card is visible, CUDA activity) and write a Chrome trace to
    ``<logdir>/trace.json``. Returns the last call's output."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = None
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            out = train_iter(*carry_args)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[debug] profiler trace -> {path}")
    return out
