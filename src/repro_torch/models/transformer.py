"""Decoder layers: the port of ``repro.models.transformer``.

Layers are grouped into homogeneous runs (``LMConfig.layer_plan``).  Where
the reference stacks a group's parameters on a leading axis and applies
them with ``lax.scan``, the port keeps an ``nn.ModuleList`` of
:class:`Layer` modules per group and runs them one after another; the
group's caches stay stacked, ``{"k": [n, B, Sc, Hkv, hd], "v": ...}``, as
in the reference, and layer i works on their slice i in place.

Layer kinds: ``attn`` (GQA attention + SwiGLU MLP) is ported.  The other
kinds raise ``NotImplementedError`` naming the ROADMAP item that brings
them.
"""
from __future__ import annotations

from torch import nn

from . import layers as L
from .config import LMConfig

# The layer kinds still to come, and the ROADMAP item that brings each.
LATER = {
    "moe": "MoE layers (models/moe.py) wait for ROADMAP queue 1 item 15e",
    "mamba": "Mamba layers (models/ssm.py) wait for the falcon-mamba-7b "
             "serving slice (ROADMAP queue 1 item 15b, queue 2 item 6)",
    "rec": "RG-LRU layers (models/rglru.py) wait for the recurrentgemma-9b "
           "serving slice (ROADMAP queue 1 item 15c, queue 2 item 7)",
    "lattn": "local-attention layers wait for the recurrentgemma-9b "
             "serving slice (ROADMAP queue 1 item 15c)",
    "super": "griffin super-blocks wait for the recurrentgemma-9b serving "
             "slice (ROADMAP queue 1 item 15c, queue 2 item 7)",
    "xdec": "encoder-decoder layers wait for the enc-dec slice (ROADMAP "
            "queue 1 item 15e)",
}


class Layer(nn.Module):
    """One layer of kind ``attn``: an :class:`~.layers.Attention` block
    and an :class:`~.layers.MLP` (``layer_init``), and the three passes
    over them: ``forward`` (the full-sequence pass of training),
    ``prefill`` and ``decode``."""

    def __init__(self, kind: str, cfg: LMConfig, device, gen=None):
        super().__init__()
        if kind in LATER:
            raise NotImplementedError(f"layer kind {kind!r}: {LATER[kind]}")
        if kind != "attn":
            raise ValueError(kind)
        self.cfg = cfg
        self.attn = L.Attention(cfg, device, gen)
        self.mlp = L.MLP(cfg, device, gen)

    def forward(self, x, pos, causal: bool = True):
        x = L.attn_train(self.attn, x, self.cfg, pos, causal=causal)
        return L.mlp(self.mlp, x, self.cfg)

    def prefill(self, x, pos, cache_len: int):
        """Returns (x, cache) with the cache zero-padded to ``cache_len``."""
        x, cache = L.attn_prefill(self.attn, x, self.cfg, pos,
                                  cache_len=cache_len)
        return L.mlp(self.mlp, x, self.cfg), cache

    def decode(self, x, cache: dict, length):
        """One token; writes its K/V into ``cache`` in place."""
        x = L.attn_decode(self.attn, x, cache, self.cfg, length)
        return L.mlp(self.mlp, x, self.cfg)

    def init_cache(self, B: int, cache_len: int) -> dict:
        return L.attn_cache_init(self.cfg, B, cache_len, self.mlp.w1.device)
