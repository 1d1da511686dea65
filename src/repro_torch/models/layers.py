"""Shared layer primitives: norms, RoPE, GQA attention, SwiGLU MLP.

The port of ``repro.models.layers``.  Parameters live in ``nn.Module``s
(:class:`Attention`, :class:`MLP`) whose attribute names are the
reference's dict keys; the math is plain functions on tensors that take
such a module as ``p``, in the reference's order of operations:

- ``rms_norm`` computes in float32 with the gemma offset ``(1 + w)`` and
  casts back;
- ``rope`` is half-split with float32 frequencies and angles;
- attention goes through ``kernels.ops`` (the CUDA kernels on the card,
  the plain versions on the CPU).

The reference's ``shard()`` constraints stand at its places
(``sharding.partition.shard``): no-ops on plain tensors, and on DTensors
(model parallelism, ``launch.train --model-par``) a redistribution to the
rules' layout.  The port adds one at the residual branches that the
reference leaves to XLA (decode's attention and recurrent steps, the
cross-attention): XLA sums a row-split product's partial results at
once, DTensor would carry the partial sum down the residual stream and
sum it again at every later use.  The products go through
``sharding.partition.matmul``, which on DTensors multiplies each rank's
shards as the reference's partitioner lays them out.  Cross-attention (:class:`CrossAttention`
and the ``xattn*`` functions) attends the encoder's output,
bidirectionally, through the same kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels import ops
from ..sharding.partition import (current_ctx, from_local, global_offset,
                                  local_part, local_span, placements,
                                  matmul, shard)
from .config import LMConfig


def dtype_of(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter, created frozen as serving wants it; training unfreezes
    the model's parameters (``model.requires_grad_()``, which
    ``train.step.init_state`` calls) and ``LM.loss_fn`` differentiates
    them."""
    return nn.Parameter(t, requires_grad=False)


def dense_init(gen: torch.Generator | None, d_in: int, d_out: int, dtype,
               device, scale: float | None = None) -> torch.Tensor:
    """[d_in, d_out] weights: float32 normals times ``scale`` (default
    ``d_in ** -0.5``), cast to ``dtype``.  Without a generator the tensor
    is left unset (shape-only models on the meta device)."""
    scale = d_in ** -0.5 if scale is None else scale
    w = torch.empty(d_in, d_out, dtype=torch.float32, device=device)
    if gen is not None:
        w.normal_(generator=gen).mul_(scale)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def rms_norm_init(d: int, device) -> torch.Tensor:
    # Stored as an offset from 1.0 (gemma convention): zero init.
    return torch.zeros(d, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

_ROPE_FREQ: dict = {}


def rope_freq(half: int, theta: float, device) -> torch.Tensor:
    """The reference's table ``theta ** (-i / half)`` (float32 [half]):
    the exponent in float32, as the reference takes it, the power in
    float64, rounded once to float32.  torch's float32 ``pow`` differs
    from the reference's in a few entries of every arch, and the angle's
    error grows with the position (1.35e-2 in ``cos`` at 524 287 with
    recurrentgemma-9b's table).  Built once a (half, theta, device);
    where a dispatch mode watches the ops (the dry run's ``OpCost``, on
    fake tensors or real ones) it is built at each call and not kept, so
    that the counts do not depend on what the process ran before."""
    watched = torch._C._len_torch_dispatch_stack() > 0
    key = (half, float(theta), torch.device(device))
    freq = None if watched else _ROPE_FREQ.get(key)
    if freq is None:
        e = -torch.arange(half, dtype=torch.float32, device=device) / half
        freq = torch.pow(float(theta), e.double()).float()
        if not watched:
            _ROPE_FREQ[key] = freq
    return freq


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, d]; pos: [B, S] integer absolute positions."""
    half = x.shape[-1] // 2
    freq = rope_freq(half, theta, x.device)
    ang = pos[..., None].float() * freq                       # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention block (pre-norm residual)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """The parameters of one GQA attention block (``attn_init``):
    ``norm``, ``wq``, ``wk``, ``wv``, ``wo``, and ``bq``/``bk``/``bv``
    (qkv_bias) and ``q_norm``/``k_norm`` (qk_norm) where the config asks.
    Padded query heads (``pad_heads_to``) get zero ``wq`` columns and
    ``wo`` rows, which leaves the function unchanged."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        D, H, Hkv, hd = cfg.d_model, cfg.n_heads_p, cfg.n_kv_heads, cfg.hd
        dt = dtype_of(cfg)
        self.norm = param(rms_norm_init(D, device))
        wq = dense_init(gen, D, H * hd, dt, device)
        wo = dense_init(gen, H * hd, D, dt, device)
        if H > cfg.n_heads and gen is not None:
            real = cfg.n_heads * hd
            wq[:, real:] = 0
            wo[real:, :] = 0
        self.wq = param(wq)
        self.wk = param(dense_init(gen, D, Hkv * hd, dt, device))
        self.wv = param(dense_init(gen, D, Hkv * hd, dt, device))
        self.wo = param(wo)
        if cfg.qkv_bias:
            self.bq = param(torch.zeros(H * hd, dtype=dt, device=device))
            self.bk = param(torch.zeros(Hkv * hd, dtype=dt, device=device))
            self.bv = param(torch.zeros(Hkv * hd, dtype=dt, device=device))
        if cfg.qk_norm:
            self.q_norm = param(rms_norm_init(hd, device))
            self.k_norm = param(rms_norm_init(hd, device))


def qkv(p: Attention, x, cfg: LMConfig, pos):
    """Projections, qk-norm and RoPE: x [B, S, D] -> q [B, S, H, hd],
    k and v [B, S, Hkv, hd]."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads_p, cfg.n_kv_heads, cfg.hd
    q, k, v = (matmul(x, w) for w in (p.wq, p.wk, p.wv))
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q, k, v = _heads(q, H, hd), _heads(k, Hkv, hd), _heads(v, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = shard(rope(q, pos, cfg.rope_theta), "act_heads")
    k = shard(rope(k, pos, cfg.rope_theta), "act_kv")
    return q, k, shard(v, "act_kv")


def _heads(x, n: int, hd: int):
    """x [B, S, n hd] -> [B, S, n, hd].  A DTensor split over its last dim
    more ways than the n heads divide (qwen3-1.7b's 8 KV heads of 128,
    whose projection the rules split 16 ways; a B = 1 cell's heads over
    both mesh dims) is first gathered on the minor mesh dims that the
    heads do not divide: the rules keep such heads whole (``act_kv``)."""
    B, S = x.shape[:2]
    if isinstance(x, DTensor):
        mesh, ways, pl = x.device_mesh, 1, []
        for i, p in enumerate(x.placements):
            # A strided shard (the last dim split over two mesh dims) has
            # a ``dim`` but is not ``is_shard``.
            if getattr(p, "dim", None) == 2:
                if n % (ways * mesh.size(i)):
                    p = Replicate()
                else:
                    ways *= mesh.size(i)
            pl.append(p)
        if tuple(pl) != tuple(x.placements):
            x = x.redistribute(mesh, tuple(pl))
    return x.reshape(B, S, n, hd)


def sdpa_train(q, k, v, cfg: LMConfig, *, window: int | None,
               causal: bool = True):
    """Full-sequence attention; with ``cfg.q_chunk`` the queries go in
    chunks, each attending the full K/V at its own position offset (the
    reference scans the chunks to bound XLA's live logits; the kernel
    takes the offset as an argument)."""
    S, qc = q.shape[1], cfg.q_chunk
    if not qc or S <= qc:
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=cfg.softcap)
    return torch.cat([
        ops.flash_attention(q[:, i:i + qc], k, v, causal=causal,
                            window=window, softcap=cfg.softcap,
                            pos_offset=i)
        for i in range(0, S, qc)], dim=1)


def attn_train(p: Attention, x, cfg: LMConfig, pos, *,
               window: int | None = None, causal: bool = True):
    B, S, _ = x.shape
    q, k, v = qkv(p, rms_norm(x, p.norm, cfg.norm_eps), cfg, pos)
    o = sdpa_train(q, k, v, cfg, window=window, causal=causal)
    o = matmul(o.reshape(B, S, cfg.n_heads_p * cfg.hd), p.wo)
    return x + shard(o, "act")


def attn_prefill(p: Attention, x, cfg: LMConfig, pos, *,
                 window: int | None = None, cache_len: int):
    """Like train, but also returns the KV cache for decode, zero-padded
    to ``cache_len`` (a ring of the last ``window`` positions for a
    windowed layer whose cache is window-sized)."""
    B, S, _ = x.shape
    q, k, v = qkv(p, rms_norm(x, p.norm, cfg.norm_eps), cfg, pos)
    o = sdpa_train(q, k, v, cfg, window=window)
    o = matmul(o.reshape(B, S, cfg.n_heads_p * cfg.hd), p.wo)
    if window is None and S > cache_len:
        raise ValueError(
            f"prefill length {S} exceeds cache_len {cache_len} "
            "(only windowed layers may ring-wrap)")
    return x + shard(o, "act"), {"k": _prefill_cache(k, cache_len, window),
                                 "v": _prefill_cache(v, cache_len, window)}


def _fill_slots(k, cache_len: int, window: int | None, lo: int, n: int):
    """Slots [lo, lo + n) of the prefill cache of k [B, S, Hkv, hd]: in
    ring order for a windowed layer whose cache is the window and shorter
    than the prompt (position p at slot p % window: slot s holds the last
    window positions' p = S - window + (s - S + window) mod window), else
    position s at slot s for s < min(S, cache_len) and zeros after."""
    B, S = k.shape[:2]
    if window is not None and cache_len == window and S > window:
        slots = torch.arange(lo, lo + n, device=k.device)
        return k[:, S - window + (slots - S + window) % window]
    out = k.new_zeros(B, n, *k.shape[2:])
    hi = min(lo + n, S, cache_len)
    if hi > lo:
        out[:, :hi - lo] = k[:, lo:hi]
    return out


def _prefill_cache(k, cache_len: int, window: int | None):
    """The prefill cache [B, cache_len, Hkv, hd] of k.  A DTensor k is
    laid out as the installed rules' ``"cache"`` spec says (the heads or
    the positions split over the model axis) and each rank fills its own
    slots from its shard of k, whole over the positions: no collective
    where k is already replicated there, as the rules keep it when the
    KV heads do not divide the axis."""
    ctx = current_ctx()
    if not isinstance(k, DTensor) or ctx is None:
        return shard(_fill_slots(k, cache_len, window, 0, cache_len),
                     "cache")
    mesh, shape = k.device_mesh, (k.shape[0], cache_len, *k.shape[2:])
    spec = tuple(ctx.act_specs["cache"])
    pl = placements(mesh, spec + (None,) * (4 - len(spec)), shape)
    kl = local_part(k, tuple(Replicate() if p.is_shard(1) else p
                             for p in pl))
    n, off = local_span(shape, mesh, pl)
    return from_local(_fill_slots(kl, cache_len, window, off[1], n[1]),
                      mesh, pl, shape)


def _write_position(cache: torch.Tensor, slot: torch.Tensor,
                    new: torch.Tensor) -> None:
    """cache[b, slot[b]] = new[b] in place, for the rows whose slot lies
    inside the cache; a row whose slot is past the end keeps its cache (the
    reference's one-hot ``where`` matches no position there).  On a
    DTensor cache each rank writes its own shard: the rank whose positions
    hold the slot (a cache split over its positions), the others keep
    their bits."""
    if isinstance(cache, DTensor):
        mesh, pl = cache.device_mesh, cache.placements
        # new [B, Hkv, hd] and slot [B] as the cache lays out its rows and
        # heads, whole over its positions.
        npl = tuple(Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(2)
                    else Replicate() for p in pl)
        spl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pl)
        off = global_offset(cache, pl)[1]
        _write_slots(cache.to_local(), local_part(slot, spl) - off,
                     local_part(new, npl))
        return
    _write_slots(cache, slot, new)


def _write_slots(cache, slot, new) -> None:
    Sc = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = slot.clamp(0, Sc - 1).long()
    inside = ((slot >= 0) & (slot < Sc))[:, None, None]
    cache[rows, idx] = torch.where(inside, new, cache[rows, idx])


def attn_decode(p: Attention, x, cache: dict, cfg: LMConfig, length, *,
                window: int | None = None):
    """x: [B, 1, D]; cache k/v: [B, Sc, Hkv, hd]; length: [B] int32, the
    tokens so far.  The new token sits at position ``length`` (ring-indexed
    when the cache is window-sized).  Its K and V are written into the
    cache in place (the reference's one-hot ``where`` gives the same
    values; the reference returns a new cache)."""
    B = x.shape[0]
    q, k, v = qkv(p, rms_norm(x, p.norm, cfg.norm_eps), cfg, length[:, None])
    kc, vc = cache["k"], cache["v"]
    Sc = kc.shape[1]
    ring = window is not None and Sc == window
    slot = length % Sc if ring else length
    _write_position(kc, slot, k[:, 0])
    _write_position(vc, slot, v[:, 0])
    o = ops.decode_attention(
        q[:, 0], kc, vc,
        (length + 1).clamp(max=Sc) if ring else length + 1,
        window=None if ring else window, softcap=cfg.softcap)
    o = matmul(o.reshape(B, 1, cfg.n_heads_p * cfg.hd), p.wo)
    return x + shard(o, "act")


def attn_cache_init(cfg: LMConfig, B: int, cache_len: int, device,
                    window: int | None = None) -> dict:
    Sc = min(cache_len, window) if window else cache_len
    shape = (B, Sc, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device)}


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder); the encoder's output is the memory.
# ---------------------------------------------------------------------------

class CrossAttention(nn.Module):
    """The parameters of one cross-attention block (``xattn_init``):
    ``norm``, ``wq`` [D, H hd], ``wk`` and ``wv`` [D, Hkv hd] and ``wo``
    [H hd, D], with the unpadded head count and no bias or qk-norm."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dt = dtype_of(cfg)
        self.norm = param(rms_norm_init(D, device))
        self.wq = param(dense_init(gen, D, H * hd, dt, device))
        self.wk = param(dense_init(gen, D, Hkv * hd, dt, device))
        self.wv = param(dense_init(gen, D, Hkv * hd, dt, device))
        self.wo = param(dense_init(gen, H * hd, D, dt, device))


def xattn_kv(p: CrossAttention, memory, cfg: LMConfig) -> dict:
    """The memory's keys and values [B, Sm, Hkv, hd], computed once a
    prefill (decode's cross cache)."""
    B, Sm, _ = memory.shape
    return {"k": matmul(memory, p.wk).reshape(B, Sm, cfg.n_kv_heads, cfg.hd),
            "v": matmul(memory, p.wv).reshape(B, Sm, cfg.n_kv_heads, cfg.hd)}


def xattn(p: CrossAttention, x, memory, cfg: LMConfig, kv=None):
    """x [B, S, D] decoder states attend memory [B, Sm, D], every query
    every position (no RoPE, no mask; S and Sm may differ).  ``kv``: the
    memory's keys and values when the caller has them (prefill keeps them
    as the cross cache)."""
    B, S, _ = x.shape
    h = rms_norm(x, p.norm, cfg.norm_eps)
    q = matmul(h, p.wq).reshape(B, S, cfg.n_heads, cfg.hd)
    kv = xattn_kv(p, memory, cfg) if kv is None else kv
    o = sdpa_train(q, kv["k"], kv["v"], cfg, window=None, causal=False)
    return x + shard(matmul(o.reshape(B, S, cfg.n_heads * cfg.hd), p.wo),
                     "act")


def xattn_decode(p: CrossAttention, x, kv: dict, cfg: LMConfig, mem_len):
    """One token x [B, 1, D] attends the first ``mem_len`` [B] (int32)
    positions of its row's cross cache; no soft-cap and no window, as in
    the reference."""
    B = x.shape[0]
    h = rms_norm(x, p.norm, cfg.norm_eps)
    q = matmul(h, p.wq).reshape(B, cfg.n_heads, cfg.hd)
    o = ops.decode_attention(q, kv["k"], kv["v"], mem_len)
    return x + shard(matmul(o.reshape(B, 1, cfg.n_heads * cfg.hd), p.wo),
                     "act")


# ---------------------------------------------------------------------------
# SwiGLU MLP block (pre-norm residual)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``norm``, ``w1`` (gate), ``w3`` (up) and ``w2`` (down)."""

    def __init__(self, cfg: LMConfig, device, gen=None,
                 d_ff: int | None = None):
        super().__init__()
        D, Fd = cfg.d_model, d_ff or cfg.d_ff
        dt = dtype_of(cfg)
        self.norm = param(rms_norm_init(D, device))
        self.w1 = param(dense_init(gen, D, Fd, dt, device))
        self.w3 = param(dense_init(gen, D, Fd, dt, device))
        self.w2 = param(dense_init(gen, Fd, D, dt, device))


def mlp(p: MLP, x, cfg: LMConfig):
    h = rms_norm(x, p.norm, cfg.norm_eps)
    a = shard(matmul(h, p.w1), "act_ff")
    b = shard(matmul(h, p.w3), "act_ff")
    return x + shard(matmul(F.silu(a) * b, p.w2), "act")
