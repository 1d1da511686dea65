"""Mesh context and activation sharding constraints: the port of
``repro.sharding.partition``.

Model code calls ``shard(x, logical_name)`` at block boundaries.  With no
installed context, or on a plain tensor, this is a no-op (one process, the
plain path); under ``use_sharding(ctx)`` a DTensor activation is
redistributed to the placements that the rules assigned to that logical
activation, as the reference's ``with_sharding_constraint`` constrains it.

Torch has no ``PartitionSpec``, so :class:`P` stands in for it: a tuple
whose entries are ``None`` (the tensor dim is replicated), an axis name,
or a tuple of axis names (the dim is split over those axes, the first the
major one, as JAX splits it).  :func:`placements` turns a spec on a mesh
into DTensor placements.

The mesh of a :class:`MeshInfo` is a ``torch.distributed.device_mesh.
DeviceMesh`` with named dims, or any object with the reference's
``.shape`` mapping (axis name -> size) and ``.axis_names`` (the rules
only read sizes, so shape-only meshes check the production layouts
without devices).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)

# The installed context.  Not a contextvar, as the reference's is: the
# autograd engine runs a CUDA backward (and with it the recomputed forward
# of a checkpointed layer) on a thread of its own, which would not see a
# contextvar set by the caller.
_CTX: list = [None]


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"),
    None)``; ``P()`` replicates every dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names, major to minor."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return tuple(names)


def axis_size(mesh, name: str) -> int:
    if isinstance(mesh.shape, tuple):          # a DeviceMesh
        return mesh.shape[axis_names(mesh).index(name)]
    return mesh.shape[name]


@dataclass(frozen=True)
class MeshInfo:
    """Physical mesh + the axis roles the rules map logical dims onto."""

    mesh: object
    dp: tuple[str, ...]           # data-parallel axes, e.g. ("pod", "data")
    tp: str = "model"             # tensor-parallel axis (or a tuple)
    # FSDP axes for parameter/optimizer shards; None -> same as dp.
    fsdp_over: tuple[str, ...] | None = None

    @property
    def tp_size(self) -> int:
        axes = self.tp if isinstance(self.tp, tuple) else (self.tp,)
        n = 1
        for a in axes:
            n *= axis_size(self.mesh, a)
        return n

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp:
            n *= axis_size(self.mesh, a)
        return n

    @property
    def fsdp(self):
        """Axes over which parameter/optimizer shards are scattered."""
        if self.fsdp_over is not None:
            return tuple(self.fsdp_over)
        return self.dp if len(self.dp) == 1 else tuple(self.dp)

    def named(self, spec: P) -> "NamedSharding":
        return NamedSharding(self.mesh, placements(self.mesh, spec))


class NamedSharding(NamedTuple):
    """A mesh and the DTensor placements of a spec on it."""

    mesh: object
    placements: tuple


def placements(mesh, spec, shape=None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that entry d names, ``Replicate()`` on every other.  A tuple
    entry splits dim d over its axes major to minor, as JAX does; DTensor
    splits a dim over mesh dims in the mesh's order, so the tuple must
    name its axes in that order.  Given the tensor's ``shape``, a dim of
    one element stays whole (a batch of one row: DTensor refuses to view
    a split dim of size 1 into another)."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None or (shape is not None and shape[d] == 1):
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        at = [names.index(a) for a in axes]
        if at != sorted(at) or len(set(at)) != len(at):
            raise ValueError(f"spec entry {entry} does not name mesh axes "
                             f"of {names} major to minor")
        for i in at:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} splits two dims of "
                                 f"{spec}")
            out[i] = Shard(d)
    return tuple(out)


@dataclass
class ShardingCtx:
    mi: MeshInfo
    act_specs: dict[str, P] = field(default_factory=dict)


@contextlib.contextmanager
def use_sharding(ctx: ShardingCtx | None):
    prev, _CTX[0] = _CTX[0], ctx
    try:
        yield
    finally:
        _CTX[0] = prev


def current_ctx() -> ShardingCtx | None:
    return _CTX[0]


def shard(x, name: str):
    """Redistribute the DTensor activation ``x`` to the logical sharding
    ``name``; a plain tensor, or no installed context, passes through."""
    ctx = _CTX[0]
    if ctx is None or not isinstance(x, DTensor):
        return x
    spec = ctx.act_specs.get(name)
    if spec is None:
        return x
    # Pad the spec with trailing None to the rank of x.
    ps = tuple(spec) + (None,) * (x.ndim - len(spec))
    y = x.redistribute(x.device_mesh,
                       placements(x.device_mesh, ps, x.shape))
    # A collective hands back contiguous shards but keeps the strides of
    # x's layout (an einsum's permuted output); a later view would take
    # those strides for the shard's and fail.  Record the shards' layout
    # (no copy: they are contiguous already).
    if y.to_local().is_contiguous() and not y.is_contiguous():
        y = y.contiguous()
    return y


# ---------------------------------------------------------------------------
# Local shards: what the kernel wrappers and the per-row MoE glue run on
# ---------------------------------------------------------------------------

def local_part(x: DTensor, placements, grad_placements=None
               ) -> torch.Tensor:
    """``x`` redistributed to ``placements``, as this rank's local shard.
    Its gradient comes back with ``grad_placements`` (by default
    ``placements``): ``Partial()`` on a mesh dim where ``x`` is replicated
    but the work that reads it is split, so each rank's gradient is a
    part of the sum."""
    x = x.redistribute(x.device_mesh, tuple(placements))
    return x.to_local(grad_placements=None if grad_placements is None
                      else tuple(grad_placements))


def from_local(t: torch.Tensor, mesh, placements, shape) -> DTensor:
    """This rank's shard ``t`` of a tensor of global ``shape``."""
    shape = torch.Size(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(t, mesh, tuple(placements), run_check=False,
                              shape=shape, stride=stride)


def cut(t: torch.Tensor, mesh, placements) -> DTensor:
    """This rank's shard of ``t`` (the same on every rank) as a DTensor,
    copied out contiguous, so that it keeps no view of the whole."""
    d = distribute_tensor(t, mesh, placements, src_data_rank=None)
    local = d.to_local()
    if local.is_contiguous():
        return d
    return DTensor.from_local(local.contiguous(), mesh, d.placements,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


def place(tree, shardings):
    """Every tensor of a nested dict laid out as its ``shardings`` entry
    (a ``NamedSharding``): a DTensor redistributed, a plain tensor (the
    same on every rank) cut to this rank's shard on the mesh's device."""
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    mesh, pl = shardings
    if isinstance(tree, DTensor):
        return tree.redistribute(mesh, pl)
    return cut(tree, mesh, pl)


def global_offset(x: DTensor, placements) -> tuple:
    """Where this rank's shard of ``x`` under ``placements`` starts."""
    return compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, tuple(placements))[1]


def grads_over(placements, split) -> tuple:
    """The gradient placements of an operand laid out as ``placements``
    when the work is split over the mesh dims that ``split`` marks:
    ``Partial()`` where it is replicated on such a dim."""
    return tuple(Partial() if s and isinstance(p, Replicate) else p
                 for p, s in zip(placements, split))


def per_row(fn, *args):
    """``fn`` on this rank's batch rows.  Where no argument is a DTensor
    this is ``fn(*args)``.  Else every DTensor argument is redistributed
    to ``Shard(0)`` on the mesh dims over which the first one splits its
    leading (batch) dim and ``Replicate()`` on the others, and ``fn``'s
    outputs (a tensor or a tuple of tensors, batch first) come back as
    DTensors laid out the same way.  For functions that work row by row
    (sorts, gathers, ordered sums) the result is the unsplit call's."""
    first = next((a for a in args if isinstance(a, DTensor)), None)
    if first is None:
        return fn(*args)
    mesh = first.device_mesh
    pl = tuple(Shard(0) if p.is_shard(0) else Replicate()
               for p in first.placements)
    out = fn(*(local_part(a, pl) if isinstance(a, DTensor) else a
               for a in args))

    def wrap(t):
        return from_local(t, mesh, pl, (first.shape[0], *t.shape[1:]))

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)
