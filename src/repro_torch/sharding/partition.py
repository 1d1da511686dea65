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

Where DTensor's own rules would repeat work on every rank or gather an
operand that the reference's partitioner keeps split, the model calls
the functions here, which work on each rank's local shards:
:func:`matmul` (every product of a weight), :func:`column_blocks`
(a product whose output columns are cut into blocks), :func:`label_logp`
(the loss's log-softmax on the vocabulary's shards), :func:`embed_rows`
(the vocabulary-split lookup), :func:`pointwise` (an elementwise
function) and :func:`amax_rows` (row maxima).  :func:`state_plan`,
:func:`to_state_layout` and :func:`to_param_layout` move an AdamW leaf
between its parameter's layout and its state's where the state splits
over the "pod" axis too.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)
from torch.utils._python_dispatch import _disable_current_modes

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
    part of the sum.  A parameter's gradient stays a ``Partial()`` sum
    over the "pod" axis (:func:`pod_partial`): the train step reduces it
    once a step, not once a microbatch."""
    if grad_placements is not None and x.is_leaf and x.requires_grad:
        back = pod_partial(x, grad_placements)
        if back != tuple(x.placements):
            return _PodPartialGrad.apply(x, tuple(placements),
                                         tuple(grad_placements), back)
    x = x.redistribute(x.device_mesh, tuple(placements))
    return x.to_local(grad_placements=None if grad_placements is None
                      else tuple(grad_placements))


def pod_dim(mesh) -> int | None:
    """The index of ``mesh``'s "pod" dim, where it has more than one
    rank, else None."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if "pod" not in names or mesh.size(names.index("pod")) == 1:
        return None
    return names.index("pod")


def pod_partial(x: DTensor, grad_placements) -> tuple:
    """The layout a gradient laid out as ``grad_placements`` is reduced
    to for the leaf ``x``: ``x``'s placements, but ``Partial()`` on the
    "pod" dim where the gradient is partial there and ``x`` replicated
    (each pod's microbatch rows give a part of the sum, which the step
    adds up over its microbatches before one reduction over the pods)."""
    out = tuple(x.placements)
    i = pod_dim(x.device_mesh)
    if i is not None and grad_placements[i].is_partial() \
            and out[i].is_replicate():
        out = out[:i] + (Partial(),) + out[i + 1:]
    return out


def param_grad(g: DTensor, p: DTensor) -> DTensor:
    """The gradient ``g`` of the parameter ``p`` in ``p``'s layout, but a
    ``Partial()`` sum over the pods where it is one
    (:func:`pod_partial`): the update reduces it once a step
    (``optimizer.adamw_update``), and the microbatches' sums add up as
    partial sums."""
    return g.redistribute(p.device_mesh, pod_partial(p, g.placements))


def pod_partial_over(x) -> bool:
    """Whether ``x`` is a DTensor that is a ``Partial()`` sum over the
    "pod" dim of its mesh."""
    if not isinstance(x, DTensor):
        return False
    i = pod_dim(x.device_mesh)
    return i is not None and x.placements[i].is_partial()


class _PodPartialGrad(torch.autograd.Function):
    """``local_part`` of a parameter whose gradient goes back to its
    layout over every mesh dim but "pod", where it stays a ``Partial()``
    sum: DTensor's own backward would reduce it to the parameter's
    layout, an all-reduce over the pods a microbatch."""

    @staticmethod
    def forward(ctx, x, placements, grad_placements, back):
        ctx.mesh, ctx.shape = x.device_mesh, x.shape
        ctx.grad_placements, ctx.back = grad_placements, back
        y = x.redistribute(x.device_mesh, placements).to_local()
        # A view, as DTensor's ``to_local`` returns under grad: where the
        # placements are x's own, ``y`` is x's local tensor itself.
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        g = from_local(dy, ctx.mesh, ctx.grad_placements, ctx.shape)
        return g.redistribute(ctx.mesh, ctx.back), None, None, None


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


def shard_module(module: torch.nn.Module, shardings: dict) -> None:
    """Replace each parameter of ``module`` by the DTensor cut from it as
    its ``shardings`` entry (a ``NamedSharding``, keyed by parameter name)
    lays it out; every rank holds the same tensors before (drawn from the
    same seed).  The new parameters are frozen, as the model's are."""
    for name, p in list(module.named_parameters()):
        owner, _, attr = name.rpartition(".")
        mesh, pl = shardings[name]
        setattr(module.get_submodule(owner), attr, torch.nn.Parameter(
            cut(p.detach(), mesh, pl), requires_grad=False))


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
    return local_span(x.shape, x.device_mesh, placements)[1]


def local_span(shape, mesh, placements) -> tuple:
    """(the shape, the offset) of this rank's shard of a tensor of
    ``shape`` laid out on ``mesh`` as ``placements`` say: host arithmetic
    on the mesh's coordinates, outside any dispatch mode (a fake-tensor
    mode would make the coordinates fake, and their values unreadable)."""
    with _disable_current_modes():
        return compute_local_shape_and_global_offset(
            torch.Size(shape), mesh, tuple(placements))


def grads_over(placements, split) -> tuple:
    """The gradient placements of an operand laid out as ``placements``
    when the work is split over the mesh dims that ``split`` marks:
    ``Partial()`` where it is replicated on such a dim."""
    return tuple(Partial() if s and isinstance(p, Replicate) else p
                 for p, s in zip(placements, split))


def embed_rows(tokens, table):
    """``F.embedding(tokens, table)``.  On a DTensor table split over its
    rows (the vocabulary over the model axis) each rank looks up the
    tokens in its own rows, zero for the others, and the sum over those
    mesh dims (an all-reduce) is the lookup, laid out as the tokens: what
    DTensor's own rule computes through its masked partial, whose
    handling differs between torch releases; the table's other dims
    (FSDP) are gathered first, and its gradient lands in each rank's rows
    alone."""
    if not isinstance(table, DTensor) or not any(
            p.is_shard(0) for p in table.placements):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate()
                 for p in table.placements)
    if isinstance(tokens, DTensor):
        tp = tuple(Shard(0) if p.is_shard(0) else Replicate()
                   for p in tokens.placements)
        ids = local_part(tokens, tp)
    else:
        tp = (Replicate(),) * mesh.ndim
        ids = tokens
    # Where the tokens are split and the table is not, each rank's
    # gradient is a part of the sum.
    local = local_part(table, rows, grads_over(rows, [
        p.is_shard(0) for p in tp]))
    lo, n = global_offset(table, rows)[0], local.shape[0]
    ids = ids - lo
    inside = (ids >= 0) & (ids < n)
    out = F.embedding(ids.clamp(0, n - 1), local) * inside[..., None]
    pl = tuple(Partial() if r.is_shard(0) else t for r, t in zip(rows, tp))
    out = from_local(out, mesh, pl, (*tokens.shape, table.shape[1]))
    return out.redistribute(mesh, tp)


def _split_dim(p):
    """The tensor dim a placement splits (a strided shard's too), else
    None."""
    return p.dim if p.is_shard() or hasattr(p, "split_factor") else None


def matmul(x, w):
    """``x @ w`` for x [..., K] and a matrix w [K, N].  On DTensors the
    product runs on each rank's local shards in the layout the
    reference's partitioner gives it, so that no rank repeats another's
    work and no operand is gathered beyond what the split needs.  Mesh
    dim by mesh dim:

    - x split over a row dim (batch or sequence): w gathered whole on
      that dim (the FSDP gather), its gradient a ``Partial()`` sum;
    - else w split over its columns N: x whole, the output split over
      its last dim, x's gradient a ``Partial()`` sum;
    - else w or x split over K: both taken split over K (a local chunk
      of the one that is whole), the output a ``Partial()`` sum, which
      the next ``shard`` reduces;
    - else both whole; where w's rows are split over the dims that split
      x's rows (FSDP), its gradient is computed a block of rows a rank
      (:func:`_row_block_plan`).

    A partial x is reduced first.  Plain tensors give ``x @ w``."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x @ w
    plan = _row_block_plan(x, w)
    if plan is not None:
        return _row_block_matmul(x, w, plan)
    last = x.ndim - 1
    xp, wp, yp, xg, wg = [], [], [], [], []
    for a, b in zip(x.placements, w.placements):
        ad, bd = _split_dim(a), _split_dim(b)
        if ad is not None and ad != last:          # rows split
            xp.append(a), wp.append(Replicate()), yp.append(a)
            xg.append(a), wg.append(Partial())
        elif bd == 1:                              # columns split
            xp.append(Replicate()), wp.append(b), yp.append(Shard(last))
            xg.append(Partial()), wg.append(b)
        elif ad == last or bd == 0:                # K split
            xp.append(Shard(last)), wp.append(Shard(0)), yp.append(Partial())
            xg.append(Shard(last)), wg.append(Shard(0))
        else:
            xp.append(Replicate()), wp.append(Replicate())
            yp.append(Replicate()), xg.append(Replicate())
            wg.append(Replicate())
    y = local_part(x, xp, xg) @ local_part(w, wp, wg)
    return from_local(y, x.device_mesh, yp, (*x.shape[:-1], w.shape[-1]))


class RowBlockPlan(NamedTuple):
    """How a rank computes its block of a weight's gradient rows: block
    ``block`` of ``blocks``, summed over the mesh dims ``sums`` and
    swapped with the global rank ``partner`` (the swap is its own
    inverse: the partner's block is this rank's shard)."""

    sums: tuple
    block: int
    blocks: int
    partner: int


def _row_block_plan(x: DTensor, w: DTensor) -> RowBlockPlan | None:
    """XLA's partitioner splits the gradient of a weight w [K, N] whose
    rows K are split over the mesh dims F that also split x's rows
    (FSDP), where x and w are both whole on the model dim M: the k =
    |F| blocks of K go to the model ranks, M's rank m computing block
    h = m // r of its rows' gradient (r = |M| / k); an all-reduce over
    the dims that split x's rows sums it, and a permute takes it to the
    rank whose shard it is: F's coordinate h, M's the sender's F
    coordinate times r plus m mod r (seen in the compiled MoE router of
    moonshot-v1-16b-a3b on the (2, 4) and (16, 16) meshes: a half and a
    sixteenth of the rows a rank).  None where the layout is another,
    k does not divide |M|, or the mesh is not the whole process group
    (the permute runs over it).

    None also where a dim splits x's rows and leaves w whole (the "pod"
    axis, plain data parallelism): there XLA computes the whole gradient
    on every rank and sums it over all the dims that split x's rows
    (seen in the same router on the (2, 2, 2) and (2, 16, 16) meshes: an
    [E, K] product a rank, an all-reduce over ("pod", "data")), as
    :func:`matmul`'s general layout does (w gathered whole, its gradient
    a ``Partial()`` sum that DTensor reduces to w's layout)."""
    mesh, last = x.device_mesh, x.ndim - 1
    if w.ndim != 2 or mesh.size() != torch.distributed.get_world_size() \
            or any(p.is_partial() for p in x.placements):
        return None
    fsdp, sums, model = [], [], []
    for i, (a, b) in enumerate(zip(x.placements, w.placements)):
        rows = _split_dim(a) not in (None, last)
        if rows and b.is_shard(0):
            fsdp.append(i), sums.append(i)
        elif rows and b.is_replicate():
            sums.append(i)
        elif a.is_replicate() and b.is_replicate():
            model += [i] if mesh.size(i) > 1 else []
        elif mesh.size(i) > 1:
            return None
    k = math.prod(mesh.size(i) for i in fsdp)
    if k < 2 or len(model) != 1 or mesh.size(model[0]) % k \
            or any(mesh.size(i) > 1 for i in sums if i not in fsdp):
        return None
    c = mesh.get_coordinate()
    m, r = c[model[0]], mesh.size(model[0]) // k
    d = 0
    for i in fsdp:
        d = d * mesh.size(i) + c[i]
    coord, h = list(c), m // r
    for i in reversed(fsdp):
        h, coord[i] = divmod(h, mesh.size(i))
    coord[model[0]] = d * r + m % r
    with _disable_current_modes():      # the mesh's ranks, on the host
        partner = int(mesh.mesh[tuple(coord)])
    return RowBlockPlan(tuple(sums), m // r, k, partner)


class _RowBlockGrad(torch.autograd.Function):
    """``x @ w_full`` on local tensors, whose backward gives x's gradient
    whole and w's as this rank's shard ``w_shard`` of its rows: the
    block of the plan computed, summed over the plan's dims by
    all-reduces and swapped with the partner (an all-to-all that sends
    one block to one rank) over the whole group."""

    @staticmethod
    def forward(ctx, x, w_full, w_shard, plan, mesh):
        ctx.save_for_backward(x, w_full)
        ctx.plan, ctx.mesh = plan, mesh
        return x @ w_full

    @staticmethod
    def backward(ctx, dy):
        x, w_full = ctx.saved_tensors
        plan, mesh = ctx.plan, ctx.mesh
        c10d = torch.ops._c10d_functional
        K, N = w_full.shape
        n = K // plan.blocks
        dy2 = dy.reshape(-1, N)
        rows = x.reshape(-1, K)[:, plan.block * n:(plan.block + 1) * n]
        g = rows.t() @ dy2
        for i in plan.sums:
            g = c10d.wait_tensor(c10d.all_reduce(
                g, "sum", mesh.get_group(i).group_name))
        world = torch.distributed.get_world_size()
        splits = [n if j == plan.partner else 0 for j in range(world)]
        g = c10d.wait_tensor(c10d.all_to_all_single(
            g, splits, splits,
            torch.distributed.distributed_c10d._get_default_group()
            .group_name))
        return dy @ w_full.t(), None, g, None, None


def _row_block_matmul(x: DTensor, w: DTensor, plan: RowBlockPlan):
    """:func:`matmul` where :func:`_row_block_plan` gives a plan: w
    gathered whole for the product (the FSDP gather), x and the output
    laid out as x, and w's gradient this rank's shard of its rows
    (``_RowBlockGrad``), laid out as w."""
    mesh = x.device_mesh
    whole = (Replicate(),) * mesh.ndim
    y = _RowBlockGrad.apply(
        local_part(x, x.placements), local_part(w.detach(), whole),
        w.to_local(grad_placements=w.placements), plan, mesh)
    return from_local(y, mesh, x.placements, (*x.shape[:-1], w.shape[-1]))


def amax_rows(x):
    """``x.amax(dim=-1, keepdim=True)``.  On a DTensor whose last dim a
    mesh dim splits, each rank's maximum and an all-reduce of the
    maxima over those mesh dims, the result whole there: the program
    both torch releases then run (2.13 alone would reduce-scatter it)."""
    if not isinstance(x, DTensor):
        return x.amax(dim=-1, keepdim=True)
    mesh, last = x.device_mesh, x.ndim - 1
    cut_last = [_split_dim(p) == last for p in x.placements]
    part = tuple(Partial("max") if c else p
                 for p, c in zip(x.placements, cut_last))
    whole = tuple(Replicate() if c else p
                  for p, c in zip(x.placements, cut_last))
    local = x.to_local().amax(dim=-1, keepdim=True)
    return from_local(local, mesh, part, (*x.shape[:-1], 1)).redistribute(
        mesh, whole)


def pointwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``, on a DTensor x on each rank's
    shard: torch 2.11's DTensor has no sharding rule for some such
    functions (``F.softplus``) and gathers x whole first."""
    if not isinstance(x, DTensor):
        return fn(x)
    return from_local(fn(x.to_local()), x.device_mesh, x.placements,
                      x.shape)


def column_blocks(x, w, n: int) -> list:
    """``(x @ w).chunk(n, dim=-1)``.  A chunk of a DTensor product whose
    columns a mesh dim splits is gathered (falcon-mamba's ``in_proj`` holds
    u and z side by side); where the product's output is the larger (a
    training or prefill step), each block of w is instead redistributed
    to w's layout and multiplied on its own (:func:`matmul`), so that
    only the weight moves."""
    split = isinstance(w, DTensor) and any(
        _split_dim(p) == 1 and w.device_mesh.size(i) > 1
        for i, p in enumerate(w.placements))
    if not split or math.prod(x.shape[:-1]) <= w.shape[0]:
        return list(matmul(x, w).chunk(n, dim=-1))
    mesh, width = w.device_mesh, w.shape[1] // n
    return [matmul(x, w[:, i * width:(i + 1) * width].redistribute(
        mesh, w.placements)) for i in range(n)]


def label_logp(logits, labels):
    """Each position's float32 log-probability of its label: logits [B, S,
    V] (float32), labels [B, S] (int64), both DTensors or neither.  On
    DTensors each rank works on its own rows; where the vocabulary is
    split over a mesh dim of more than one rank, the log-softmax is taken
    on the shards (the rows' max and sum of exponentials and the label's
    logit combined by all-reduces over those dims), as the reference's
    partitioner keeps it, instead of gathering the vocabulary.  Elsewhere
    (plain tensors, or the vocabulary whole on every rank) it is the
    plain log-softmax on each rank's rows."""
    if not isinstance(logits, DTensor):
        return _label_logp(logits, labels)
    mesh, last = logits.device_mesh, logits.ndim - 1
    vocab = [_split_dim(p) == last and mesh.size(i) > 1
             for i, p in enumerate(logits.placements)]
    rows = tuple(Replicate() if _split_dim(p) in (None, last) else p
                 for p in logits.placements)
    lab = local_part(labels, rows)
    shape = logits.shape[:-1]
    if not any(vocab):
        return from_local(_label_logp(local_part(logits, rows), lab), mesh,
                          rows, shape)
    cols = tuple(Shard(last) if v else r for r, v in zip(rows, vocab))
    local = local_part(logits, cols)
    lo, n = global_offset(logits, cols)[last], local.shape[-1]

    def over_vocab(t, op="sum"):
        pl = tuple(Partial(op) if v else r for r, v in zip(rows, vocab))
        return from_local(t, mesh, pl, shape).redistribute(mesh, rows)

    m = over_vocab(local.detach().amax(dim=-1), "max").to_local()
    s = over_vocab(torch.exp(local - m[..., None]).sum(dim=-1))
    ids = lab - lo
    inside = (ids >= 0) & (ids < n)
    picked = local.gather(-1, ids.clamp(0, n - 1)[..., None])[..., 0]
    picked = over_vocab(picked * inside)
    return picked - from_local(m, mesh, rows, shape) - torch.log(s)


def _label_logp(logits, labels):
    """The plain float32 log-softmax's entry at each position's label."""
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, labels[..., None])[..., 0]


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


# ---------------------------------------------------------------------------
# The optimizer state on a mesh of pods (hierarchical ZeRO)
# ---------------------------------------------------------------------------

class StatePlan(NamedTuple):
    """How one leaf moves between its parameter's layout and its
    optimizer state's, where the state splits the tensor dim ``dim`` over
    the mesh dim ``pod`` too, over which the parameter is whole
    (:func:`state_plan`).  Spans are along ``dim``: ``param_start`` and
    ``state_start`` where this rank's shards start in the two layouts,
    ``piece`` this rank's part of its parameter shard (start, stop);
    ``to_state`` and ``to_param`` the exchanges between that part and the
    state's shard (:func:`_moves`); ``gathered`` the lengths of the pod
    group's parts, in the group's order."""

    mesh: object
    shape: torch.Size
    dim: int
    pod: int
    param: tuple
    state: tuple
    param_start: int
    state_start: int
    piece: tuple
    to_state: tuple
    to_param: tuple
    gathered: tuple


def _chunk(lo: int, hi: int, n: int, i: int) -> tuple:
    """Chunk ``i`` of ``n`` of the span [lo, hi), as ``torch.chunk`` and
    DTensor's ``Shard`` cut it (chunks of ceil(len / n), the last ones
    shorter or empty)."""
    size = -(-(hi - lo) // n)
    return (lo + min(i * size, hi - lo), lo + min((i + 1) * size, hi - lo))


def _span(length: int, mesh, placements, dim: int, coord) -> tuple:
    """The span of tensor dim ``dim`` (of ``length``) that the rank at
    mesh coordinate ``coord`` holds under ``placements``: split by each
    mesh dim that shards it, in the mesh's order, as DTensor splits it."""
    lo, hi = 0, length
    for i, p in enumerate(placements):
        if p == Shard(dim):
            lo, hi = _chunk(lo, hi, mesh.size(i), coord[i])
    return lo, hi


def state_plan(x: DTensor, placements) -> StatePlan | None:
    """The plan that moves the leaf ``x`` (laid out as its parameter)
    to ``placements`` (its optimizer state's) and back, or None where
    the two layouts are one, or differ otherwise than in one mesh dim
    (the "pod" axis) over which the parameter is whole and the state
    splits a tensor dim that the parameter's other mesh dims may split
    too, or where the mesh is not the whole process group (the exchanges
    run over it).  Such leaves keep DTensor's own redistribution.

    The state splits the dim pod-major, as the reference's
    ``P(("pod", "data"))`` does: rank (p, d) holds chunk p |data| + d of
    |pod| |data|, which lies in the parameter's shard of another data
    rank.  So the plan goes through a layout nested in the parameter's,
    chunk d |pod| + p (``piece``: a local slice): the state's shard is
    one exchange away from it (a permutation of whole chunks where the
    dim divides evenly, a collective-permute), and the parameter's shard
    is that layout gathered over the pod axis.  The reference's compiled
    update permutes and gathers likewise (its new moments, where the
    port moves the gradient and the new parameter)."""
    mesh = x.device_mesh
    src, dst = tuple(x.placements), tuple(placements)
    if src == dst or len(src) != len(dst):
        return None
    plain = (Replicate, Shard)
    if any(type(p) not in plain for p in src + dst):
        return None                         # partial or strided
    diff = [i for i, (a, b) in enumerate(zip(src, dst)) if a != b]
    if len(diff) != 1 or not src[diff[0]].is_replicate():
        return None
    pod, dim = diff[0], dst[diff[0]].dim
    world = torch.distributed.get_world_size()
    if mesh.size() != world:
        return None
    me = tuple(mesh.get_coordinate())
    length = x.shape[dim]
    # The ranks that split ``dim`` between them: every coordinate of the
    # mesh dims that shard it in the state's layout, the others this
    # rank's.
    axes = [i for i, p in enumerate(dst) if p == Shard(dim)]
    members = []
    for flat in range(math.prod(mesh.size(i) for i in axes)):
        c = list(me)
        for i in reversed(axes):
            flat, c[i] = divmod(flat, mesh.size(i))
        members.append(tuple(c))
    with _disable_current_modes():      # the mesh's ranks, on the host
        rank = {c: int(mesh.mesh[c]) for c in members}

    def nested(c):
        lo, hi = _span(length, mesh, src, dim, c)
        return _chunk(lo, hi, mesh.size(pod), c[pod])

    have = {c: nested(c) for c in members}
    want = {c: _span(length, mesh, dst, dim, c) for c in members}
    # DTensor's own arithmetic for this rank, as a check on the spans
    # (an empty shard's offset is DTensor's convention, not checked).
    for pl, span in ((src, _span(length, mesh, src, dim, me)),
                     (dst, want[me])):
        shape, off = local_span(x.shape, mesh, pl)
        if shape[dim] != span[1] - span[0] or (
                shape[dim] and off[dim] != span[0]):
            raise RuntimeError(f"state_plan: DTensor lays {pl} out at "
                               f"{off[dim]} + {shape[dim]}, not {span}")
    group = tuple(c for c in members if all(
        c[i] == me[i] for i in range(len(me)) if i != pod))
    return StatePlan(mesh, x.shape, dim, pod, src, dst,
                     _span(length, mesh, src, dim, me)[0], want[me][0],
                     have[me], _moves(have, want, rank, me, world),
                     _moves(want, have, rank, me, world),
                     tuple(have[c][1] - have[c][0] for c in group))


def _moves(have: dict, want: dict, rank: dict, me, world: int) -> tuple:
    """This rank's part of the exchange from the spans ``have`` to the
    spans ``want`` (coordinate -> (start, stop)): (the spans it sends, in
    the receivers' rank order; the send sizes and the receive sizes per
    rank of the group of ``world``; the order, by start, of the pieces it
    receives, which arrive in the senders' rank order)."""
    def overlap(a, b):
        return max(a[0], b[0]), min(a[1], b[1])

    sends = sorted((rank[c], overlap(have[me], want[c])) for c in want)
    recvs = sorted((rank[c], overlap(have[c], want[me])) for c in have)
    sends = [(r, s) for r, s in sends if s[1] > s[0]]
    recvs = [(r, s) for r, s in recvs if s[1] > s[0]]
    send_sizes, recv_sizes = [0] * world, [0] * world
    for r, (a, b) in sends:
        send_sizes[r] += b - a
    for r, (a, b) in recvs:
        recv_sizes[r] += b - a
    order = sorted(range(len(recvs)), key=lambda j: recvs[j][1][0])
    return (tuple(s for _, s in sends), tuple(send_sizes),
            tuple(recv_sizes), tuple(order))


def _exchange(t: torch.Tensor, start: int, moves: tuple, dim: int):
    """Rows (along ``dim``) of ``t``, which holds the span from ``start``,
    sent and received as ``moves`` (:func:`_moves`) says, by one
    all-to-all over the whole group; returns the received span."""
    spans, send_sizes, recv_sizes, order = moves
    c10d = torch.ops._c10d_functional
    x = t.movedim(dim, 0)
    parts = [x[a - start:b - start] for a, b in spans] or [x[:0]]
    x = parts[0].contiguous() if len(parts) == 1 else torch.cat(parts)
    group = torch.distributed.distributed_c10d._get_default_group()
    out = c10d.wait_tensor(c10d.all_to_all_single(
        x, list(recv_sizes), list(send_sizes), group.group_name))
    if list(order) != sorted(order):
        parts = out.split([n for n in recv_sizes if n])
        out = torch.cat([parts[j] for j in order])
    return out.movedim(0, dim)


def to_state_layout(x: DTensor, plan: StatePlan) -> DTensor:
    """``x`` (laid out as the leaf's parameter: the same on every pod)
    in the state's layout: this rank's part of its shard
    (``plan.piece``, a local slice) exchanged for its state shard.  A
    gradient that is a ``Partial()`` sum over the pods (the train step
    on a mesh of pods) takes its part by one reduce-scatter over the pod
    axis instead of a slice."""
    a, b = plan.piece
    if x.placements[plan.pod].is_partial():
        part = _pod_reduce_scatter(x.to_local(), plan)
    else:
        part = x.to_local().narrow(plan.dim, a - plan.param_start, b - a)
    y = _exchange(part, a, plan.to_state, plan.dim)
    return from_local(y.contiguous(), plan.mesh, plan.state, plan.shape)


def _pod_reduce_scatter(t: torch.Tensor, plan: StatePlan) -> torch.Tensor:
    """This rank's part (``plan.piece``) of the sum over the pod group of
    the parameter shards ``t``: the shard cut along ``plan.dim`` into the
    group's parts (``plan.gathered``, consecutive, padded to the longest
    where they differ) and reduce-scattered over the pod axis."""
    c10d = torch.ops._c10d_functional
    sizes = plan.gathered
    n, own = max(sizes), plan.piece[1] - plan.piece[0]
    x = t.movedim(plan.dim, 0)
    if n == 0:                  # the pod group's parts are all empty
        return x[:0].movedim(0, plan.dim)
    if any(s != n for s in sizes):
        x = torch.cat([torch.cat([p, p.new_zeros((n - p.shape[0],
                                                  *p.shape[1:]))])
                       for p in x.split(list(sizes))])
    group = plan.mesh.get_group(plan.pod)
    out = c10d.wait_tensor(c10d.reduce_scatter_tensor(
        x.contiguous(), "sum", len(sizes), group.group_name))
    return out[:own].movedim(0, plan.dim)


def to_param_layout(x: DTensor, plan: StatePlan) -> DTensor:
    """``x`` (laid out as the leaf's state) in the parameter's layout:
    its state shard exchanged for this rank's part of its parameter
    shard, which an all-gather over the pod axis completes (parts padded
    to the longest where the dim does not divide evenly)."""
    c10d = torch.ops._c10d_functional
    part = _exchange(x.to_local(), plan.state_start, plan.to_param,
                     plan.dim).movedim(plan.dim, 0)
    n, sizes = max(plan.gathered), plan.gathered
    if n == 0:                  # the pod group's shards are all empty
        whole = part
    else:
        if part.shape[0] < n:
            part = torch.cat([part, part.new_zeros((n - part.shape[0],
                                                    *part.shape[1:]))])
        group = plan.mesh.get_group(plan.pod)
        whole = c10d.wait_tensor(c10d.all_gather_into_tensor(
            part.contiguous(), len(sizes), group.group_name))
        if any(s != n for s in sizes):
            whole = torch.cat([whole[j * n:j * n + s]
                               for j, s in enumerate(sizes)])
    y = whole.movedim(0, plan.dim).contiguous()
    return from_local(y, plan.mesh, plan.param, plan.shape)
