"""Mixture-of-Experts block: top-k routing with capacity-sort dispatch.

The port of ``repro.models.moe``.  Token assignments are sorted by expert
within each batch row and each expert takes its first C of them
(``capacity``), giving dense ``[B, E, C, D]`` buffers; the three expert
products are plain batched products (cuBLAS on the card), as in the
reference, which has no Pallas kernel here.  The reference's ``shard()``
constraints stand at its places.  On DTensors (model parallelism) the
router and the expert products follow the rules (experts split over the
model axis when it divides their count, else each expert's d_ff), and
the per-row pieces (the top-k sort and the capacity sort) run on each
rank's batch rows (``sharding.partition.per_row``), and the gather into
the experts' slots and the combine's ordered adds on each rank's rows
and its own experts, the combine a partial sum that the ``act`` layout
reduces, as the reference's partitioner sums it.

Where the reference leaves an order to its library, the port fixes the
one the reference computes:

- top-k by a stable descending sort, so that tied probabilities pick the
  lower expert first, as ``jax.lax.top_k`` does;
- the assignments sorted by a stable ``argsort``, as ``jnp.argsort``;
- the combine adds each token's kept contributions one after another in
  the model dtype, in the order of the reference's scatter-add (expert
  ascending), without atomics: with K = 6 in bfloat16 the sum depends on
  its order.

The load-balancing aux loss multiplies each expert's count of assignments
by ``1 / (B S K)``, one rounding where the reference adds the constant once
per assignment (the two may differ in the last bits).  Nothing in the block
reads a value back to the host or copies one to the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.profiler import record_function

from ..sharding.partition import (current_ctx, from_local, global_offset,
                                  grads_over, local_part, local_span,
                                  matmul, per_row, placements, shard)
from .config import LMConfig
from .layers import dense_init, dtype_of, param, rms_norm, rms_norm_init


# The profiler ranges of the block's pieces: the norm, the router and the
# capacity sort with the gathers into the experts' slots, the three expert
# products, and the gating and the combine (forward passes; the backward
# runs in autograd's own nodes).
RANGES = ("moe dispatch", "moe expert products", "moe combine")


def _expert_init(gen, shape, scale: float, dtype, device) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if gen is not None:
        w.normal_(generator=gen).mul_(scale)
    return w.to(dtype)


class MoE(nn.Module):
    """The parameters of one MoE block (``moe_init``): ``norm`` [D],
    ``router`` [D, E] (float32), ``we1`` and ``we3`` [E, D, F] (gate and
    up) and ``we2`` [E, F, D] (down) in the model dtype."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = dtype_of(cfg)
        self.norm = param(rms_norm_init(D, device))
        self.router = param(dense_init(gen, D, E, torch.float32, device))
        self.we1 = param(_expert_init(gen, (E, D, Fd), D ** -0.5, dt, device))
        self.we3 = param(_expert_init(gen, (E, D, Fd), D ** -0.5, dt, device))
        self.we2 = param(_expert_init(gen, (E, Fd, D), Fd ** -0.5, dt,
                                      device))

    def forward(self, x: torch.Tensor, cfg: LMConfig,
                capacity_factor: float | None = None):
        """:func:`moe_mlp` on this block."""
        return moe_mlp(self, x, cfg, capacity_factor)


def capacity(cfg: LMConfig, S: int, capacity_factor: float | None = None
             ) -> int:
    """Slots an expert has in a row of S tokens: 1 at decode (a token's
    top-k experts are distinct, so one slot each drops nothing), else
    ``S K cf / E`` + 1 rounded up to a multiple of 8 (at least 8); cf is
    ``capacity_factor``, by default the config's."""
    if S == 1:
        return 1
    cf = cfg.capacity_factor if capacity_factor is None else capacity_factor
    c = int(S * cfg.top_k * cf / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)


def route(p: MoE, h: torch.Tensor, cfg: LMConfig):
    """The router on normed states h [B, S, D]: float32 probabilities
    [B, S, E], the top-k gates renormalised to sum to 1 and the chosen
    experts [B, S, K] (highest first; among ties the lower index)."""
    probs = torch.softmax(matmul(h.float(), p.router), dim=-1)
    return (probs, *per_row(lambda pr: top_k(pr, cfg.top_k), probs))


def top_k(probs: torch.Tensor, K: int):
    """The K largest probabilities of each token, renormalised, and their
    experts (highest first; among ties the lower index)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = vals[..., :K], idx[..., :K]
    return gates / gates.sum(-1, keepdim=True).clamp(min=1e-9), eidx


def aux_loss(probs: torch.Tensor, eidx: torch.Tensor, E: int) -> torch.Tensor:
    """Switch load balancing: ``E * sum_e mean(probs)_e * frac_e``, frac_e
    the share of the B S K assignments that chose expert e."""
    me = _mean_rows(probs)
    if not isinstance(eidx, DTensor):
        ce = expert_counts(eidx, E).float() * (1.0 / eidx.numel())
        return E * torch.sum(me * ce)
    # On DTensors each rank's share of the loss from its own counts, the
    # loss a ``Partial()`` sum over the mesh dims that split the rows
    # (torch 2.11's DTensor would all-reduce the shares first; 2.13's
    # keeps them partial, and so does this, on both).
    mesh = eidx.device_mesh
    part = tuple(Partial() if p.is_shard(0) else Replicate()
                 for p in eidx.placements)
    ce = expert_counts(eidx.to_local(), E).float() * (1.0 / eidx.numel())
    dims = tuple(i for i, p in enumerate(part) if p.is_partial())
    return from_local(_AuxShare.apply(me.to_local(), ce, E, mesh, dims),
                      mesh, part, ())


class _AuxShare(torch.autograd.Function):
    """``E * sum(me * ce)`` on local tensors: me the mean probabilities
    (whole on every rank), ce this rank's part of the shares (no
    gradient).  The backward gives me's gradient whole, from the shares
    summed over ``dims`` by all-reduces, one a mesh dim in the mesh's
    order, as DTensor reduces a partial operand there."""

    @staticmethod
    def forward(ctx, me, ce, E, mesh, dims):
        ctx.save_for_backward(ce)
        ctx.E, ctx.mesh, ctx.dims = E, mesh, dims
        return E * torch.sum(me * ce)

    @staticmethod
    def backward(ctx, g):
        ce, = ctx.saved_tensors
        c10d = torch.ops._c10d_functional
        gs = (g * ctx.E).expand(ce.shape)
        for i in ctx.dims:
            ce = c10d.wait_tensor(c10d.all_reduce(
                ce, "sum", ctx.mesh.get_group(i).group_name))
        return gs * ce, None, None, None, None


def _mean_rows(probs: torch.Tensor) -> torch.Tensor:
    """``probs.mean(dim=(0, 1))``.  A DTensor split over its batch rows
    sums its rows on each rank and the ranks' sums by an all-reduce, so
    that the gradient reaches each rank's rows without a collective
    (DTensor's own rule reduce-scatters it on torch 2.13, not on 2.11)."""
    if not isinstance(probs, DTensor):
        return probs.mean(dim=(0, 1))
    mesh, whole = probs.device_mesh, (Replicate(),) * probs.device_mesh.ndim
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate()
                 for p in probs.placements)
    split = tuple(p.is_shard(0) and mesh.size(i) > 1
                  for i, p in enumerate(rows))
    local = local_part(probs, rows)
    if not any(split):
        return from_local(local.mean(dim=(0, 1)), mesh, whole,
                          probs.shape[2:])
    part = tuple(Partial() if s else Replicate() for s in split)
    total = local.sum(dim=(0, 1)) / (probs.shape[0] * probs.shape[1])
    return from_local(total, mesh, part, probs.shape[2:]).redistribute(
        mesh, whole)


def expert_counts(eidx: torch.Tensor, E: int) -> torch.Tensor:
    """How many of the assignments eidx chose each expert ([E] integers;
    a DTensor split over the batch counts its rows and sums across the
    ranks)."""
    if isinstance(eidx, DTensor):
        part = tuple(Partial() if p.is_shard(0) else Replicate()
                     for p in eidx.placements)
        return from_local(expert_counts(eidx.to_local(), E),
                          eidx.device_mesh, part, (E,))
    flat = eidx.reshape(-1)
    # Integer counts by scatter_add_ (bincount would read its input's
    # largest value back to the host); the share a Python scalar, which
    # the product takes in float32 without a copy to the card.
    counts = torch.zeros(E, dtype=torch.long, device=flat.device)
    return counts.scatter_add_(0, flat, torch.ones_like(flat))


def dispatch(eidx: torch.Tensor, E: int, C: int):
    """The per-row capacity sort of the assignments eidx [B, S, K]:
    ``tok`` [B, E, C], the token each expert slot takes (clamped in
    range where the slot is empty), ``valid`` [B, E, C], ``assign`` [B,
    E, C], the assignment (s K + k) in each slot, and ``slot`` [B, S K],
    the slot e C + c each assignment lands in (C or more past capacity:
    dropped)."""
    B, S, K = eidx.shape
    flat_e = eidx.reshape(B, S * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    counts = torch.zeros(B, E, dtype=torch.long, device=eidx.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=-1) - counts
    cs = torch.arange(C, device=eidx.device)
    slots = starts[:, :, None] + cs                       # [B, E, C]
    valid = cs < counts[:, :, None]
    assign = torch.gather(order, 1, slots.clamp(max=S * K - 1).reshape(
        B, E * C)).reshape(B, E, C)
    # Each assignment's rank in the sorted order, less its expert's start:
    # its slot within the expert.
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(S * K, device=eidx.device).expand(B, -1))
    within = rank - torch.gather(starts, 1, flat_e)
    slot = torch.where(within < C, flat_e * C + within, E * C)
    return assign // K, valid, assign, slot


def combine(ye: torch.Tensor, slot: torch.Tensor, eidx: torch.Tensor,
            first: int = 0, E: int | None = None):
    """The experts' gated outputs ye [B, E, C, D] summed back per token
    [B, S, D]: each token's kept contributions added one after another in
    ye's dtype, its experts ascending (the reference's scatter-add order:
    expert, then slot), starting from zero.  ye may hold the experts
    ``first`` on of E (a rank's own experts): then the sum is of theirs
    alone."""
    B, El, C, D = ye.shape
    E = El if E is None else E
    S, K = eidx.shape[1:]
    # The token's assignments with their experts in ascending order.
    perm = torch.argsort(eidx, dim=-1)
    slot = torch.gather(slot.reshape(B, S, K), 2, perm) - first * C
    kept = (slot >= 0) & (slot < El * C) if El < E else slot < E * C
    rows = torch.gather(ye.reshape(B, El * C, D), 1,
                        torch.where(kept, slot, 0).reshape(B, S * K, 1)
                        .expand(-1, -1, D)).reshape(B, S, K, D)
    rows = torch.where(kept[..., None], rows, 0)
    y = torch.zeros(B, S, D, dtype=ye.dtype, device=ye.device)
    for k in range(K):
        y = y + rows[:, :, k]
    return y


def gather(h: torch.Tensor, gates: torch.Tensor, tok, valid, assign, slot,
           eidx, first: int = 0, E: int | None = None):
    """The experts' inputs xe [B, E, C, D] (the normed states of each
    slot's token, 0 in the empty slots) and the slots' gates [B, E, C]
    (float32, 0 in the empty slots).  The gradient of h sums each token's
    kept slots in the combine's order (:class:`SlotGather`).  tok, valid
    and assign may hold the experts ``first`` on of E (a rank's own)."""
    B = h.shape[0]
    El, C = tok.shape[1:]
    gsel = torch.gather(gates.reshape(B, -1), 1, assign.reshape(B, El * C))
    gsel = torch.where(valid, gsel.reshape(B, El, C), 0.0)
    return SlotGather.apply(h, tok, valid, slot, eidx, first, E), gsel


class SlotGather(torch.autograd.Function):
    """xe[b, e, c] = h[b, tok[b, e, c]] in a kept slot, 0 in an empty one
    (whose gate is 0, so the block's output is the same either way).  Its
    backward adds each token's kept slots' gradients in the combine's
    order (:func:`combine`), so that the gradient of h is the same bits
    every run: ``torch.gather``'s backward adds a token's K rows with
    atomics on the card, in no fixed order."""

    @staticmethod
    def forward(ctx, h, tok, valid, slot, eidx, first=0, E=None):
        B, El, C = tok.shape
        D = h.shape[-1]
        ctx.save_for_backward(slot, eidx)
        ctx.first, ctx.E = first, E
        xe = torch.gather(h, 1, tok.reshape(B, El * C, 1).expand(-1, -1, D))
        return torch.where(valid[..., None], xe.reshape(B, El, C, D), 0)

    @staticmethod
    def backward(ctx, g):
        slot, eidx = ctx.saved_tensors
        return (combine(g, slot, eidx, ctx.first, ctx.E),
                None, None, None, None, None, None)


def experts(p: MoE, xe: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU MLP on its slots: [B, E, C, D] -> [B, E, C,
    D], three batched products over the experts."""
    xe = shard(xe, "moe_disp")
    if isinstance(xe, DTensor):
        return _experts_on_shards(p, xe)
    return _swiglu(xe, p.we1, p.we3, p.we2)


def _swiglu(xe, we1, we3, we2):
    a = torch.einsum("becd,edf->becf", xe, we1)
    b = torch.einsum("becd,edf->becf", xe, we3)
    return torch.einsum("becf,efd->becd", F.silu(a) * b, we2)


def _experts_on_shards(p: MoE, xe: DTensor) -> DTensor:
    """:func:`experts` on each rank's shards (DTensor's own einsum
    mis-strides the sharded batch in its backward).  On each mesh dim: the
    batch rows split (the weights gathered: their FSDP shards), or the
    experts split (expert-parallel), or each expert's d_ff split
    (tensor-parallel inside the experts: the gate and up products and
    ``moe_ff`` hold a slice of d_ff, and the down product is a partial
    sum), or nothing."""
    xp, w13, w2p, out, split = [], [], [], [], []
    for px, pw in zip(xe.placements, p.we1.placements):
        if px.is_shard(0) or px.is_shard(1):
            d = 0 if px.is_shard(0) else 1
            xp.append(Shard(d))
            w = Shard(0) if d == 1 else Replicate()
            w13.append(w)
            w2p.append(w)
            out.append(Shard(d))
        elif pw.is_shard(2):
            xp.append(Replicate())
            w13.append(Shard(2))
            w2p.append(Shard(1))
            out.append(Partial())
        else:
            xp.append(Replicate())
            w13.append(Replicate())
            w2p.append(Replicate())
            out.append(Replicate())
        split.append(not isinstance(out[-1], Replicate))
    local = [local_part(xe, xp, grads_over(xp, split))]
    for w, pl in ((p.we1, w13), (p.we3, w13), (p.we2, w2p)):
        local.append(local_part(w, pl, grads_over(pl, split)))
    return from_local(_swiglu(*local), xe.device_mesh, out, xe.shape)


def moe_mlp(p: MoE, x: torch.Tensor, cfg: LMConfig,
            capacity_factor: float | None = None):
    """x [B, S, D] -> (x + the experts' mixture [B, S, D], the aux loss, a
    float32 scalar).  ``capacity_factor`` overrides the config's (a
    dropless check).  The pieces run under ``torch.profiler`` ranges
    (``RANGES``), so that a profile attributes their device time."""
    E = cfg.n_experts
    C = capacity(cfg, x.shape[1], capacity_factor)
    with record_function(RANGES[0]):
        h = rms_norm(x, p.norm, cfg.norm_eps)
        probs, gates, eidx = route(p, h, cfg)
        aux = aux_loss(probs, eidx, E)
        tok, valid, assign, slot = per_row(
            lambda e: dispatch(e, E, C), eidx)
        xe, gsel = _gather_own(h, gates, tok, valid, assign, slot, eidx)
    with record_function(RANGES[1]):
        ye = experts(p, xe)
    with record_function(RANGES[2]):
        y = x + shard(_combine_own(ye, gsel, slot, eidx).to(x.dtype),
                      "act")
    return y, aux


def _own_experts(x: DTensor) -> tuple:
    """(row placements, expert placements, the mesh dims that split the
    experts) of a dispatch buffer [B, E, C, ...] laid out as ``moe_disp``
    says, the rows as x's: ``Shard(0)`` where x splits its batch,
    ``Shard(1)`` where the rules split the experts."""
    mesh = x.device_mesh
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate()
                 for p in x.placements)
    ctx = current_ctx()
    spec = ctx.act_specs.get("moe_disp") if ctx is not None else None
    disp = placements(mesh, spec) if spec is not None else rows
    split = tuple(p.is_shard(1) and mesh.size(i) > 1
                  for i, p in enumerate(disp))
    own = tuple(Shard(1) if e else r for r, e in zip(rows, split))
    return rows, own, split


def _gather_own(h, gates, tok, valid, assign, slot, eidx):
    """:func:`gather` on each rank's batch rows and its own experts (the
    experts the rules give it), so that the dispatch buffers come out
    split over the experts without a gather; the gradients of h and of
    the gates are then ``Partial()`` sums over those mesh dims (each
    rank's experts' part).  Plain tensors: :func:`gather`."""
    if not isinstance(h, DTensor):
        return gather(h, gates, tok, valid, assign, slot, eidx)
    rows, own, split = _own_experts(h)
    mesh, E = h.device_mesh, tok.shape[1]
    idx = [local_part(t, rows) for t in (tok, valid, assign, slot, eidx)]
    shape, offset = local_span(tok.shape, mesh, own)
    first, n = offset[1], shape[1]
    tk, vl, asg = (t[:, first:first + n] for t in idx[:3])
    part = grads_over(rows, split)
    xe, gsel = gather(local_part(h, rows, part), local_part(gates, rows, part),
                      tk, vl, asg, idx[3], idx[4], first, E)
    return (from_local(xe, mesh, own, (*tok.shape, h.shape[-1])),
            from_local(gsel, mesh, own, tok.shape))


def _combine_own(ye, gsel, slot, eidx):
    """The experts' outputs ye gated by gsel and combined
    (:func:`combine`), on each rank's batch rows and its own experts: a
    ``Partial()`` sum over the mesh dims that split the experts (or over
    which ye is itself a partial sum), which the ``act`` layout reduces,
    instead of a gather of every expert's outputs; the gates' gradient
    is summed over D on each rank before it is reduced.  Plain tensors:
    ``combine(ye * gsel, ...)``."""
    if not isinstance(ye, DTensor):
        return combine(ye * gsel[..., None].to(ye.dtype), slot, eidx)
    rows, own, split = _own_experts(ye)
    mesh, E = ye.device_mesh, ye.shape[1]
    pl = tuple(p if p.is_partial() else o
               for p, o in zip(ye.placements, own))
    partial = [p.is_partial() for p in ye.placements]
    first = global_offset(ye, own)[1]
    # A partial ye's gradient is the whole sum's: replicated; the gates'
    # is a partial sum where ye is one.
    grad = tuple(Replicate() if p.is_partial() else p for p in pl)
    g = local_part(gsel, own, grads_over(own, partial))
    y = combine(local_part(ye, pl, grad) * g[..., None].to(ye.dtype),
                local_part(slot, rows), local_part(eidx, rows), first, E)
    out = tuple(Partial() if s or p else r
                for r, s, p in zip(rows, split, partial))
    return from_local(y, mesh, out, (*eidx.shape[:2], ye.shape[-1]))
