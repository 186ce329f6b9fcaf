"""Data parallelism over ``torch.distributed``: the env axis split over a
1-D ``data`` mesh of ranks, one process per card (port of the JAX
package's ``parallel/sharding.py``).

JAX keeps the train iteration unchanged and lets GSPMD partition it from
the input shardings. The port does by hand what GSPMD did there:

- every env-axis leaf of the env state is split: rank r of W holds the
  envs ``[r N/W, (r+1) N/W)`` (N divisible by W, as ``NamedSharding``
  requires); params, both Adam states, the LR, the command curriculum and
  the sampler's generator are replicated;
- every rank seeds the same generator and makes the same draws in
  lockstep. A draw on the env axis, by its stream's name
  (:data:`STREAM_AXES`, never by its shape: N/W can equal another
  dimension), is made at the global shape and the rank keeps its rows
  (:class:`ShardedSampler`); any other draw, such as ``ppo/minibatch``, is
  used whole on every rank. No draw depends on the rank;
- the reductions over the batch are sums all-reduced over the ranks: the
  advantage normalization, each minibatch's losses, KL and gradients (a
  rank holds a varying share of a global minibatch: it sums over its own
  samples and divides by the global minibatch size), the adaptation loss
  and its gradients, the per-bin sysid residuals, the rollout's metrics;
- the command curriculum's update runs on every rank from its inputs
  gathered to global order, so its weights stay identical everywhere.

So a sharded iteration computes what one process computes over all N
envs, up to the rounding of the sums' order, for any W.

Every collective is an ``all_reduce`` or a ``broadcast``, the two that gloo
offers for CUDA tensors: a gather is an all-reduce of a zero-padded global
buffer, which is exact. Processes: ``torch.distributed.init_process_group``
first (``scripts/train_cuda.py --distributed``: NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``); without a process group
the mesh is a world of one and every collective is the identity.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist

ENV_AXIS = "env"
REPLICATED = "replicated"

# Every random stream of the env and the learner, by the first part of its
# name: drawn per env (at the global shape, each rank keeping its rows) or
# used whole on every rank.
STREAM_AXES = {
    "action": ENV_AXIS,              # learn/ppo.py rollout's action noise
    "init_noise": ENV_AXIS,          # observation noise
    "noise": ENV_AXIS,
    "push": ENV_AXIS,
    "terrain": ENV_AXIS,             # terrain/init_levels, terrain/levels
    "init_rigid_props": ENV_AXIS,    # friction, restitution, payload, com
    "reset_rigid_props": ENV_AXIS,
    "init_dof_props": ENV_AXIS,      # motor strength, Kp, Kd factors
    "dof_props": ENV_AXIS,
    "reset_dof_props": ENV_AXIS,
    "init_sim": ENV_AXIS,            # spawn x/y, joint angles, root velocity
    "reset_sim": ENV_AXIS,
    "reset_envs": ENV_AXIS,          # the Runner's eval-env resets
    "init_commands": ENV_AXIS,       # curriculum bins and cell offsets
    "resample": ENV_AXIS,
    "runner": ENV_AXIS,              # runner/init_ep_len
    "ppo": REPLICATED,               # ppo/minibatch permutation
}


def stream_axis(name: str) -> str:
    """:data:`ENV_AXIS` or :data:`REPLICATED` for a stream's name; an
    unclassified stream raises, so that no draw is split by guess."""
    head = name.split("/")[0]
    if head not in STREAM_AXES:
        raise KeyError(f"random stream {name!r} is not classified in "
                       f"parallel.sharding.STREAM_AXES")
    return STREAM_AXES[head]


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``size`` ranks, one process per device: this process
    is ``rank`` on ``device``."""
    rank: int
    size: int
    device: torch.device
    axis_name: str = "data"


def make_mesh(device: Union[None, str, torch.device] = None,
              axis_name: str = "data") -> Mesh:
    """The mesh over the process group's ranks (a world of one without a
    group), with this process on ``device``: by default ``cuda:LOCAL_RANK``
    when a card is visible, else the CPU."""
    ready = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if ready else 0
    size = dist.get_world_size() if ready else 1
    if device is None:
        device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
                  if torch.cuda.is_available() else torch.device("cpu"))
    return Mesh(rank, size, torch.device(device), axis_name)


@dataclass(frozen=True)
class EnvShard:
    """The rows of the env axis that one rank holds, and the global
    counts."""
    mesh: Mesh
    num_envs: int          # global
    num_train_envs: int    # global: envs [0, num_train_envs) train

    def __post_init__(self):
        if self.num_envs % self.mesh.size:
            raise ValueError(f"{self.num_envs} envs do not split over "
                             f"{self.mesh.size} ranks")

    @property
    def local(self) -> int:
        return self.num_envs // self.mesh.size

    @property
    def lo(self) -> int:
        return self.mesh.rank * self.local

    @property
    def hi(self) -> int:
        return self.lo + self.local

    @property
    def local_train(self) -> int:
        """This rank's train envs: its first rows (eval envs are the last
        of the global axis)."""
        return max(0, min(self.hi, self.num_train_envs) - self.lo)

    def index(self, device) -> torch.Tensor:
        """Global indices of this rank's envs."""
        return torch.arange(self.lo, self.hi, device=device)


# ---------------------------------------------------------------------------
# collectives: all_reduce and broadcast only
def _is_nccl() -> bool:
    return dist.get_backend() == "nccl"


def _collective(t: torch.Tensor, mesh: Mesh, op: Callable) -> torch.Tensor:
    """Run ``op`` on ``t`` in place, through the mesh's device when NCCL
    cannot take ``t`` where it lies (the CPU) or as it is (bool)."""
    if mesh.size == 1:
        return t
    on = t
    if (_is_nccl() and t.device.type != "cuda") or t.dtype == torch.bool:
        on = t.to(mesh.device if _is_nccl() else t.device,
                  torch.uint8 if t.dtype == torch.bool else t.dtype)
    op(on)
    if on is not t:
        t.copy_(on.to(t.dtype))
    return t


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the ranks, in place."""
    return _collective(t, mesh, dist.all_reduce)


def broadcast_(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """``t`` set to rank ``src``'s, in place."""
    return _collective(t, mesh, lambda x: dist.broadcast(x, src))


def gather_env_axis(x: torch.Tensor, shard: EnvShard) -> torch.Tensor:
    """This rank's rows of an env-axis tensor -> the global [N, ...]
    tensor on every rank (an all-reduce of zero-padded buffers, exact)."""
    if shard.mesh.size == 1:
        return x
    buf = x.new_zeros((shard.num_envs,) + tuple(x.shape[1:]))
    buf[shard.lo:shard.hi] = x
    return all_reduce_sum(buf, shard.mesh)


def all_reduce_flat(tensors: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """Sums over the ranks of several float tensors in one all-reduce."""
    if mesh.size == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce_sum(flat, mesh)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


# ---------------------------------------------------------------------------
# the sampler of one rank
class ShardedSampler:
    """A :class:`..sampler.Sampler` seen from one rank: an env-axis draw
    (by :func:`stream_axis`) asked at this rank's shape is made at the
    global shape, and this rank keeps its rows; any other draw passes
    whole."""

    def __init__(self, base, shard: EnvShard):
        self.base = base
        self.shard = shard

    @property
    def generator(self):
        return self.base.generator

    @property
    def device(self):
        return self.base.device

    def _global(self, name, shape):
        shape = tuple(int(s) for s in shape)
        if stream_axis(name) == REPLICATED:
            return shape, False
        if not shape or shape[0] != self.shard.local:
            raise ValueError(f"env-axis draw {name!r} of shape {shape} does "
                             f"not lead with this rank's {self.shard.local} "
                             f"envs")
        return (self.shard.num_envs,) + shape[1:], True

    def _rows(self, x, split):
        return x[self.shard.lo:self.shard.hi] if split else x

    def uniform(self, name, shape, lo, hi):
        g, split = self._global(name, shape)
        return self._rows(self.base.uniform(name, g, lo, hi), split)

    def normal(self, name, shape):
        g, split = self._global(name, shape)
        return self._rows(self.base.normal(name, g), split)

    def integers(self, name, shape, lo, hi):
        g, split = self._global(name, shape)
        return self._rows(self.base.integers(name, g, lo, hi), split)

    def permutation(self, name, n):
        if stream_axis(name) != REPLICATED:
            raise ValueError(f"permutation {name!r} on the env axis")
        return self.base.permutation(name, n)

    def categorical(self, name, weights, n):
        g, split = self._global(name, (n,))
        return self._rows(self.base.categorical(name, weights, g[0]), split)


# ---------------------------------------------------------------------------
# placement (the JAX module's five functions)
def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (named tuples, tuples, lists and
    dicts of leaves) and of the trees of the same structure in ``rest``."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def env_axis_sharding(tree: Any, num_envs: int, mesh: Optional[Mesh] = None,
                      axis_name: str = "data") -> Any:
    """Placement tree: leaves with a leading env axis -> ``Shard(0)``, the
    rest ``Replicate()`` (JAX's ``P(axis)`` and ``P()``, by the same rule on
    the leaf's shape)."""
    from torch.distributed.tensor import Replicate, Shard

    def spec(leaf):
        if hasattr(leaf, "ndim") and leaf.ndim >= 1 and \
                leaf.shape[0] == num_envs:
            return Shard(0)
        return Replicate()
    return _tree_map(spec, tree)


def _env_state_placements(env_state: Any, num_envs: int) -> Any:
    """:func:`env_axis_sharding` with the command curriculum replicated
    even when its bin count equals the env count (JAX's rule would split
    it there and GSPMD gather it back; the port updates it on every rank
    from gathered inputs)."""
    from torch.distributed.tensor import Replicate
    specs = env_axis_sharding(env_state, num_envs)
    if hasattr(env_state, "curriculum"):
        specs = specs._replace(curriculum=_tree_map(
            lambda _: Replicate(), env_state.curriculum))
    return specs


def place_env_state(env_state: Any, num_envs: int, mesh: Mesh,
                    axis_name: str = "data") -> Any:
    """The global env state -> this rank's: its rows of every split leaf,
    every leaf on the mesh's device."""
    from torch.distributed.tensor import Shard
    shard = EnvShard(mesh, num_envs, num_envs)
    specs = _env_state_placements(env_state, num_envs)

    def place(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if isinstance(spec, Shard):
            leaf = leaf[shard.lo:shard.hi]
        return leaf.to(mesh.device).clone()
    return _tree_map(place, env_state, specs)


def gather_env_state(env_state: Any, shard: EnvShard) -> Any:
    """This rank's env state -> the global one on every rank (collective:
    every rank calls it)."""
    from torch.distributed.tensor import Shard
    specs = _env_state_placements(env_state, shard.local)
    return _tree_map(
        lambda x, s: gather_env_axis(x, shard) if isinstance(s, Shard)
        else x, env_state, specs)


def place_train_state(ppo_state: Any, mesh: Mesh) -> Any:
    """Rank 0's params, both Adam states and LR on every rank (the
    optimizers' tensors are broadcast in place; returns the state with the
    broadcast LR)."""
    for opt in (ppo_state.opt, ppo_state.adapt_opt):
        if opt is None:
            continue
        for group in opt.param_groups:
            for p in group["params"]:
                with torch.no_grad():
                    broadcast_(p.data, mesh)
                for k in sorted(opt.state.get(p, {})):
                    v = opt.state[p][k]
                    if isinstance(v, torch.Tensor):
                        broadcast_(v, mesh)
    lr = torch.tensor([ppo_state.lr], dtype=torch.float32,
                      device=mesh.device)
    return ppo_state._replace(lr=float(broadcast_(lr, mesh).item()))


def make_sharded_runner_placement(runner, mesh: Optional[Mesh] = None,
                                  axis_name: str = "data") -> Mesh:
    """Shard a Runner's live state over the mesh in place: this rank's rows
    of the env state, rank 0's train state and generator everywhere, the
    env switched to its rows, the sampler to :class:`ShardedSampler`."""
    mesh = mesh or make_mesh(runner.device, axis_name)
    env = runner.env
    runner.env_state = place_env_state(runner.env_state, env.num_envs, mesh,
                                       axis_name)
    runner.ppo_state = place_train_state(runner.ppo_state, mesh)
    gen = runner.sampler.generator
    gen.set_state(broadcast_(gen.get_state(), mesh))
    shard = env.shard_env_axis(mesh)
    runner.sampler = ShardedSampler(runner.sampler, shard)
    return mesh
