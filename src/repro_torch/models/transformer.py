"""Decoder layers: the port of ``repro.models.transformer``.

Layers are grouped into homogeneous runs (``LMConfig.layer_plan``; an
encoder-decoder model's decoder is one group of ``xdec`` layers and its
encoder one of ``attn``).  Where the reference stacks a group's
parameters on a leading axis and applies them with ``lax.scan``, the port
keeps an ``nn.ModuleList`` of :class:`Layer` modules per group and runs
them one after another; the group's caches stay stacked on a leading
layer axis, as in the reference (``{"k": [n, B, Sc, Hkv, hd], "v": ...}``
for attention, nested dicts for a super-block or a cross-attention
layer), and layer i works on their slice i in place.

Layer kinds:

- ``attn``  — GQA attention + SwiGLU MLP (dense; the encoder's layers
  with the mask off);
- ``moe``   — GQA attention + top-k MoE MLP (``models.moe``); its
  training pass also returns the load-balancing aux loss;
- ``lattn`` — local (sliding-window) attention + MLP (griffin), its cache
  ``min(cache_len, window)`` positions, a ring when the window is shorter;
- ``rec``   — RG-LRU recurrent block + MLP (griffin);
- ``mamba`` — Mamba-1 block;
- ``super`` — one griffin super-block: ``cfg.pattern`` of ``rec`` and
  ``lattn`` sub-blocks ``s0``, ``s1``, ...;
- ``xdec``  — decoder layer of an encoder-decoder model: self-attention,
  cross-attention to the encoder's output (the memory), MLP; its cache
  ``{"self": attention cache, "cross": the memory's K and V}``.
"""
from __future__ import annotations

from collections import Counter

from torch import nn

from . import layers as L
from .config import LMConfig
from .moe import MoE
from .rglru import RGLRU, rglru_cache_init, rglru_decode, rglru_train
from .ssm import Mamba, mamba_cache_init, mamba_decode, mamba_train


def _sub_kind(ch: str) -> str:
    return "rec" if ch == "r" else "lattn"


def leaf_kinds(cfg: LMConfig) -> Counter:
    """The number of leaf layers of each kind in the model, a super-block
    counted as its ``cfg.pattern`` of sub-layers."""
    n = Counter()
    for kind, count in cfg.layer_plan():
        for sub in ([_sub_kind(ch) for ch in cfg.pattern]
                    if kind == "super" else [kind]):
            n[sub] += count
    return n


class Layer(nn.Module):
    """One layer of ``kind`` with the reference's parameters
    (``layer_init``: ``attn`` and ``mlp``, ``attn`` and ``moe``, ``rec``
    and ``mlp``, ``mamba``, ``attn``, ``xattn`` and ``mlp``, or the
    sub-layers ``s0``...), and the three passes over them: ``run`` (the
    full-sequence pass of training, which ``forward`` calls), ``prefill``
    and ``decode``.  An ``xdec`` layer takes the encoder's output
    (``memory`` [B, Sm, D]) in the full-sequence passes and the memory's
    valid length (``mem_len`` [B]) at decode."""

    def __init__(self, kind: str, cfg: LMConfig, device, gen=None):
        super().__init__()
        self.kind, self.cfg = kind, cfg
        if kind in ("attn", "lattn", "moe", "xdec"):
            self.attn = L.Attention(cfg, device, gen)
        elif kind == "rec":
            self.rec = RGLRU(cfg, device, gen)
        elif kind == "mamba":
            self.mamba = Mamba(cfg, device, gen)
        elif kind == "super":
            self.subs = [Layer(_sub_kind(ch), cfg, device, gen)
                         for ch in cfg.pattern]
            for i, sub in enumerate(self.subs):
                self.add_module(f"s{i}", sub)
        else:
            raise ValueError(kind)
        if kind == "moe":
            self.moe = MoE(cfg, device, gen)
        if kind == "xdec":
            self.xattn = L.CrossAttention(cfg, device, gen)
        if kind in ("attn", "lattn", "rec", "xdec"):
            self.mlp = L.MLP(cfg, device, gen)
        # The local-attention window (None: global attention).
        self.window = (cfg.window or None) if kind == "lattn" else None

    def forward(self, x, pos, causal: bool = True, memory=None):
        return self.run(x, pos, causal, memory)[0]

    def run(self, x, pos, causal: bool = True, memory=None):
        """The training pass: (x, aux), aux the MoE layer's load-balancing
        loss (a float32 scalar) or None for the other kinds."""
        cfg = self.cfg
        if self.kind == "super":
            for sub in self.subs:
                x = sub(x, pos, causal)
            return x, None
        if self.kind == "mamba":
            return mamba_train(self.mamba, x, cfg), None
        if self.kind == "rec":
            x = rglru_train(self.rec, x, cfg)
        elif self.kind in ("moe", "xdec"):
            # Causal whatever the caller asks, as in the reference.
            x = L.attn_train(self.attn, x, cfg, pos)
        else:
            # A local-attention layer is causal whatever the caller asks,
            # as in the reference.
            x = L.attn_train(self.attn, x, cfg, pos, window=self.window,
                             causal=causal or self.kind == "lattn")
        if self.kind == "moe":
            return self.moe(x, cfg)
        if self.kind == "xdec":
            x = L.xattn(self.xattn, x, memory, cfg)
        return L.mlp(self.mlp, x, cfg), None

    def prefill(self, x, pos, cache_len: int, memory=None,
                capacity_factor: float | None = None):
        """Returns (x, cache); an attention cache is zero-padded to
        ``cache_len`` (``min(cache_len, window)`` for ``lattn``).  An MoE
        layer runs at the prompt's capacity (``capacity_factor``, by
        default the config's) and its aux loss is dropped."""
        cfg = self.cfg
        if self.kind == "super":
            cache = {}
            for i, sub in enumerate(self.subs):
                x, cache[f"s{i}"] = sub.prefill(x, pos, cache_len)
            return x, cache
        if self.kind == "mamba":
            return mamba_train(self.mamba, x, cfg, return_cache=True)
        if self.kind == "rec":
            x, cache = rglru_train(self.rec, x, cfg, return_cache=True)
        else:
            w = self.window
            x, cache = L.attn_prefill(
                self.attn, x, cfg, pos, window=w,
                cache_len=min(cache_len, w) if w else cache_len)
        if self.kind == "moe":
            return self.moe(x, cfg, capacity_factor)[0], cache
        if self.kind == "xdec":
            kv = L.xattn_kv(self.xattn, memory, cfg)
            x = L.xattn(self.xattn, x, memory, cfg, kv)
            cache = {"self": cache, "cross": kv}
        return L.mlp(self.mlp, x, cfg), cache

    def decode(self, x, cache: dict, length, mem_len=None):
        """One token; writes the new cache entries into ``cache`` in
        place.  An MoE layer runs with S = 1 (one slot an expert)."""
        cfg = self.cfg
        if self.kind == "super":
            for i, sub in enumerate(self.subs):
                x = sub.decode(x, cache[f"s{i}"], length)
            return x
        if self.kind == "mamba":
            return mamba_decode(self.mamba, x, cache, cfg)
        if self.kind == "rec":
            x = rglru_decode(self.rec, x, cache, cfg)
        elif self.kind == "xdec":
            x = L.attn_decode(self.attn, x, cache["self"], cfg, length)
            x = L.xattn_decode(self.xattn, x, cache["cross"], cfg, mem_len)
        else:
            x = L.attn_decode(self.attn, x, cache, cfg, length,
                              window=self.window)
        if self.kind == "moe":
            return self.moe(x, cfg)[0]
        return L.mlp(self.mlp, x, cfg)

    def init_cache(self, B: int, cache_len: int, mem_len: int = 0) -> dict:
        cfg = self.cfg
        device = next(self.parameters()).device
        if self.kind == "super":
            return {f"s{i}": sub.init_cache(B, cache_len)
                    for i, sub in enumerate(self.subs)}
        if self.kind == "mamba":
            return mamba_cache_init(cfg, B, device)
        if self.kind == "rec":
            return rglru_cache_init(cfg, B, device)
        cache = L.attn_cache_init(cfg, B, cache_len, device,
                                  window=self.window)
        if self.kind == "xdec":
            kv = L.attn_cache_init(cfg, B, mem_len, device)
            cache = {"self": cache, "cross": kv}
        return cache
