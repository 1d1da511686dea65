"""The kernel wrappers on DTensor operands: each rank calls the wrapper on
its local shards.

Under model parallelism (``sharding.rules``) the attention operands are
split over the batch (the data axes) and the heads (the model axis), and
the scans' over the batch and the channels; attention and both scans are
independent across those, so each rank runs the hand-written kernel (on
the card) or the plain version (on the CPU) on its shards, never a gather
to full tensors followed by one call.  A decode cache split over its
positions (the rules' layout where the KV heads do not divide the model
axis, in prefill's and decode's caches) is not independent across the
ranks: each runs the decode kernel on its positions, with its row's
log-sum-exp, and the partial softmaxes merge by all-reduces.  The
wrappers' launch and plain-call counters count these calls as any
other.

An operand that is replicated on a mesh dim over which the work is split
(K and V where the KV heads do not divide the model axis, the scan's A
and D across the batch, its B and C across the channels) gets a partial
gradient on each rank: ``sharding.partition.local_part`` returns it with
``Partial()`` there, so autograd sums it.  The functions here take the
wrapper to call, so that the wrapper modules keep the dispatch.
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import Replicate, Shard

from ..sharding.partition import (from_local, global_offset, grads_over,
                                  local_part)


def _split(placements, dims) -> list:
    """Per mesh dim: whether ``placements`` split one of ``dims`` there."""
    return [any(p.is_shard(d) for d in dims) for p in placements]


def _pair_kv(k, v, H: int, Hkv: int, head_off: int, Hl: int,
             kv_off: int, contiguous: bool = False):
    """This rank's K and V (local heads from ``kv_off``) cut to pair with
    its ``Hl`` query heads from ``head_off`` of H: query head h reads KV
    head h // (H / Hkv).  Where the local KV heads already pair with the
    local query heads in the kernel's grouping they pass as they are; else
    the heads they read, as a slice, or one KV head a query head."""
    g = H // Hkv
    want = [(head_off + j) // g - kv_off for j in range(Hl)]
    n = k.shape[2]
    if n and Hl % n == 0 and want == [j // (Hl // n) for j in range(Hl)]:
        return k, v
    lo, hi = want[0], want[-1] + 1
    if Hl % (hi - lo) == 0 and want == [lo + j // (Hl // (hi - lo))
                                        for j in range(Hl)]:
        k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    else:
        k, v = k[:, :, want], v[:, :, want]
    if contiguous:
        k, v = k.contiguous(), v.contiguous()
    return k, v


def _attention_plan(q, k, head_dim: int, seq_dim: int | None = None):
    """Placements of q and of K/V (and K/V's gradient) for attention: the
    batch split where q's is, q's heads (and sequence) kept split, K/V
    split on heads only where theirs are too and the split keeps whole
    groups, else replicated (with a partial gradient)."""
    H, Hkv = q.shape[head_dim], k.shape[2]
    split_dims = (head_dim,) if seq_dim is None else (head_dim, seq_dim)
    qp, kp = [], []
    for pq, pk in zip(q.placements, k.placements):
        if pq.is_shard(0):
            qp.append(Shard(0))
            kp.append(Shard(0))
        elif any(pq.is_shard(d) for d in split_dims):
            qp.append(pq)
            kp.append(Shard(2) if pq.is_shard(head_dim) and pk.is_shard(2)
                      else Replicate())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
    mesh = q.device_mesh
    n = 1
    for i, p in enumerate(kp):
        if p.is_shard(2):
            n *= mesh.size(i)
    if n > 1 and (Hkv % n or H % n):
        kp = [Replicate() if p.is_shard(2) else p for p in kp]
    kg = grads_over(kp, _split(qp, split_dims))
    return tuple(qp), tuple(kp), kg


def flash_attention(fn, q, k, v, causal, window, scale, softcap,
                    pos_offset):
    """``fn`` (the flash-attention wrapper) on each rank's shards of
    q [B, Sq, Hq, d] and k, v [B, Sk, Hkv, d]: the batch and the query
    heads (or the query sequence, context parallel) split, K and V split
    with the heads or replicated."""
    qp, kp, kg = _attention_plan(q, k, head_dim=2, seq_dim=1)
    ql = local_part(q, qp)
    kl, vl = local_part(k, kp, kg), local_part(v, kp, kg)
    qo, ko = global_offset(q, qp), global_offset(k, kp)
    kl, vl = _pair_kv(kl, vl, q.shape[2], k.shape[2], qo[2], ql.shape[2],
                      ko[2])
    off = (k.shape[1] - q.shape[1] if pos_offset is None
           else int(pos_offset)) + qo[1]
    out = fn(ql, kl, vl, causal=causal, window=window, scale=scale,
             softcap=softcap, pos_offset=off)
    return from_local(out, q.device_mesh, qp, q.shape)


def decode_attention(fn, q, k_cache, v_cache, lengths, scale, window,
                     softcap):
    """``fn`` (the decode wrapper) on each rank's shards of q [B, Hq, d],
    the caches [B, S, Hkv, d] and lengths [B]: the batch and the heads
    split, or the cache split over its positions (the rules' layout for
    KV heads that the model axis does not divide), which
    :func:`_decode_over_positions` merges across the ranks."""
    if any(p.is_shard(1) for p in k_cache.placements):
        return _decode_over_positions(fn, q, k_cache, v_cache, lengths,
                                      scale, window, softcap)
    qp, kp, _ = _attention_plan(q, k_cache, head_dim=1)
    ql = local_part(q, qp)
    kl, vl = local_part(k_cache, kp), local_part(v_cache, kp)
    qo, ko = global_offset(q, qp), global_offset(k_cache, kp)
    kl, vl = _pair_kv(kl, vl, q.shape[1], k_cache.shape[2], qo[1],
                      ql.shape[1], ko[2], contiguous=True)
    lp = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in qp)
    out = fn(ql, kl, vl, local_part(lengths, lp), scale=scale,
             window=window, softcap=softcap)
    return from_local(out, q.device_mesh, qp, q.shape)


def _decode_over_positions(fn, q, k_cache, v_cache, lengths, scale, window,
                           softcap):
    """Decode attention on a cache split over its positions.  Each rank
    runs ``fn`` on its own positions [off, off + S_l) for every query
    head of its batch rows, with the local length ``clamp(length - off,
    0)`` (the kernel sees no position past S_l; the window, p >= length -
    window, stays against the global position), and gets its rows'
    output o_r and log-sum-exp lse_r.  The ranks merge them as XLA's
    partial softmax does: M = max_r lse_r (an all-reduce), w_r =
    e^(lse_r - M) (0 for a rank that sees no position, lse_r = -inf),
    out = sum_r w_r o_r / sum_r w_r (sum all-reduces, in float32), zeros
    where no rank sees a position: ``ref.merge_decode_ref`` over the
    ranks."""
    mesh = q.device_mesh
    pos = [i for i, p in enumerate(k_cache.placements) if p.is_shard(1)]
    batch = [p.is_shard(0) for p in k_cache.placements]
    kp = tuple(Shard(0) if b else Shard(1) if i in pos else Replicate()
               for i, b in enumerate(batch))
    rp = _pl(batch)
    ql = local_part(q, rp).contiguous()
    kl, vl = local_part(k_cache, kp), local_part(v_cache, kp)
    off = global_offset(k_cache, kp)[1]
    lens = (local_part(lengths, rp) - off).clamp(min=0)
    if window is None:
        lens = lens.clamp(max=kl.shape[1])
    out, lse = fn(ql, kl.contiguous(), vl.contiguous(),
                  lens.to(lengths.dtype), scale=scale, window=window,
                  softcap=softcap, return_lse=True)
    big = lse
    for i in pos:
        big = funcol.all_reduce(big, "max", (mesh, i))
    w = torch.where(lse > -math.inf, torch.exp(lse - big), 0.0)
    num = w[..., None] * out.float()
    for i in pos:
        num = funcol.all_reduce(num, "sum", (mesh, i))
        w = funcol.all_reduce(w, "sum", (mesh, i))
    merged = torch.where(w[..., None] > 0, num / w.clamp(min=1e-30)[..., None],
                         0.0).to(out.dtype)
    return from_local(merged, mesh, rp, q.shape)


def _scan_plan(x):
    """Per mesh dim of x [B, S, C]: whether it splits the batch, and
    whether the channels (the sequence is never split: it is walked)."""
    return ([p.is_shard(0) for p in x.placements],
            [p.is_shard(2) for p in x.placements])


def _pl(first, second=None, d1: int = 0, d2: int = 0) -> tuple:
    """Per mesh dim: ``Shard(d1)`` where ``first`` is set, else
    ``Shard(d2)`` where ``second`` is, else ``Replicate()``."""
    second = second or [False] * len(first)
    return tuple(Shard(d1) if f else Shard(d2) if s else Replicate()
                 for f, s in zip(first, second))


def selective_scan(fn, x, dt, A, B, C, D, h0):
    """``fn`` (the selective-scan wrapper) on each rank's shards: x, dt
    [Bt, S, Di] split over the batch and the channels, A [Di, N] and D
    [Di] with the channels, B and C [Bt, S, N] with the batch, h0
    [Bt, Di, N] with both."""
    batch, chan = _scan_plan(x)
    split = [b or c for b, c in zip(batch, chan)]
    xp = _pl(batch, chan, 0, 2)
    ap = _pl(chan)
    bp = _pl(batch)
    hp = _pl(batch, chan, 0, 1)
    xl, dtl = local_part(x, xp), local_part(dt, xp)
    Al = local_part(A, ap, grads_over(ap, split))
    Dl = local_part(D, ap, grads_over(ap, split))
    Bl = local_part(B, bp, grads_over(bp, split))
    Cl = local_part(C, bp, grads_over(bp, split))
    hl = None if h0 is None else local_part(h0, hp)
    y, hT = fn(xl, dtl, Al, Bl, Cl, Dl, hl)
    mesh = x.device_mesh
    return (from_local(y, mesh, xp, x.shape),
            from_local(hT, mesh, hp, (x.shape[0], x.shape[2], A.shape[1])))


def rglru_scan(fn, x, a, h0):
    """``fn`` (the RG-LRU wrapper) on each rank's shards: x, a [B, S, D]
    split over the batch and the channels, h0 [B, D] with both."""
    batch, chan = _scan_plan(x)
    xp = _pl(batch, chan, 0, 2)
    hp = _pl(batch, chan, 0, 1)
    hl = None if h0 is None else local_part(h0, hp)
    y, hT = fn(local_part(x, xp), local_part(a, xp), hl)
    mesh = x.device_mesh
    return (from_local(y, mesh, xp, x.shape),
            from_local(hT, mesh, hp, (x.shape[0], x.shape[2])))
