"""Top-level model assembly: the port of ``repro.models.model``.

``LM(cfg, device, generator)`` is the reference's
``build_model(cfg).init(key)``: the parameters, on the card unless the
caller names another device, drawn from a ``torch.Generator``.  Its
methods are the reference's callables: ``loss_fn(batch)`` -> (loss,
metrics), ``prefill(batch, cache_len)`` -> (logits, caches),
``decode_step(batch, caches)`` -> logits, ``init_cache(B, cache_len,
mem_len=0)`` and ``param_count()``.  Batches use the reference's keys: train
``{"tokens": [B, S], "labels": [B, S]}``, prefill ``{"tokens": [B, S]}``
(each + ``"patch_embeds"`` [B, P, D] for the VLM stub, + ``"src_embeds"``
[B, Se, D] for the encoder-decoder's audio stub), decode ``{"tokens": [B,
1], "lengths": [B]}`` with int32 lengths (+ ``"mem_len"`` [B], int32, the
encoder positions each row attends, for the encoder-decoder).  The
parameters are created frozen (serving, under ``torch.no_grad``);
training unfreezes them (``model.requires_grad_()``).  ``decode_step``
writes the new cache entries (K/V, conv windows, recurrent states) into
``caches`` in place (the reference returns new caches).  A group's cache is a dict of stacked tensors, nested
for a griffin super-block (``models.tree``).

Every family of the ten architectures is ported for serving and for
training: dense, VLM stub, MoE, SSM (falcon-mamba), hybrid
(recurrentgemma) and encoder-decoder (seamless; its encoder runs
bidirectionally over ``src_embeds`` and its decoder's layers attend the
result).  The scans' gradients go through their autograd Functions
(``kernels.selective_scan.SelectiveScan`` and
``kernels.rglru_scan.RGLRUScan``), attention's through
``kernels.flash_attention.FlashAttention``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..core.proxies import resolve_device
from ..sharding.partition import embed_rows, label_logp, matmul, shard
from .config import LMConfig
from .layers import dense_init, dtype_of, param, rms_norm, rms_norm_init
from .transformer import Layer
from .tree import tree_index, tree_map, tree_stack


# The parameter trees whose groups stack their layers in the reference
# (``init_params``' "groups" and an encoder-decoder model's "enc_groups");
# the port keeps them as ModuleLists under the same names.
GROUP_KEYS = ("groups", "enc_groups")


def enc_plan(cfg: LMConfig) -> list:
    """The encoder's groups of an encoder-decoder model."""
    return [("attn", cfg.n_enc_layers)]


def dec_plan(cfg: LMConfig) -> list:
    """The decoder's groups: ``xdec`` layers for an encoder-decoder model,
    else the config's layer plan."""
    if cfg.family == "encdec":
        return [("xdec", cfg.n_layers)]
    return cfg.layer_plan()


class LM(nn.Module):
    """The parameters (``init_params``): ``embed`` [Vp, D], ``groups``
    (one ``ModuleList`` of :class:`~.transformer.Layer` per group of the
    decoder's plan), ``final_norm`` [D], unless tied ``lm_head`` [D, Vp],
    and for an encoder-decoder model ``enc_groups`` (the encoder's layers)
    and ``enc_norm`` [D].  Matrices in the config's dtype, norms in
    float32, as the reference keeps them.

    The numbers come from ``generator`` (a ``torch.Generator`` on
    ``device``; the reference draws from ``jax.random``, so the numbers
    differ, the distributions do not).  ``generator=None`` leaves them
    unset, e.g. for shapes on the meta device or before
    ``load_state_dict``."""

    def __init__(self, cfg: LMConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        D, Vp = cfg.d_model, cfg.vocab_padded
        dt = dtype_of(cfg)
        self.cfg = cfg
        self.embed = param(dense_init(generator, Vp, D, dt, dev, D ** -0.5))
        self.groups = _stack(dec_plan(cfg), cfg, dev, generator)
        self.final_norm = param(rms_norm_init(D, dev))
        if not cfg.tie_embeddings:
            self.lm_head = param(dense_init(generator, D, Vp, dt, dev,
                                            D ** -0.5))
        if cfg.family == "encdec":
            self.enc_groups = _stack(enc_plan(cfg), cfg, dev, generator)
            self.enc_norm = param(rms_norm_init(D, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_count(self) -> int:
        return sum(t.numel() for t in self.parameters())

    def _embed(self, tokens):
        # sqrt(d_model) rounded to the model dtype first, as the reference
        # does (45.2548 is 45.25 in bfloat16).  ``embed_rows`` reads the
        # rows the reference's indexing reads, each rank its own where the
        # table is split over the vocabulary.
        return embed_rows(tokens, self.embed) * torch.tensor(
            self.cfg.d_model ** 0.5, dtype=dtype_of(self.cfg),
            device=self.device)

    def _logits(self, x):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return shard(matmul(x, head).float(), "logits")

    def _encode(self, src_embeds):
        """The encoder: its ``attn`` layers over ``src_embeds`` [B, Se, D]
        bidirectionally (cast to the model dtype), then ``enc_norm``."""
        cfg = self.cfg
        x = src_embeds.to(dtype_of(cfg))
        B, Se = x.shape[:2]
        pos = torch.arange(Se, device=x.device)[None].expand(B, -1)
        for group in self.enc_groups:
            for layer in group:
                x = self._run(layer, x, pos, causal=False)[0]
        return rms_norm(x, self.enc_norm, cfg.norm_eps)

    def _memory(self, batch):
        """The encoder's output for an encoder-decoder model, else None."""
        if self.cfg.family != "encdec":
            return None
        return self._encode(batch["src_embeds"])

    def _run(self, layer, x, pos, causal: bool = True, memory=None):
        """A layer's training pass, under ``checkpoint`` with
        ``cfg.remat`` when gradients are being taken."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(layer.run, x, pos, causal, memory,
                              use_reentrant=False)
        return layer.run(x, pos, causal, memory)

    def _prep_inputs(self, batch):
        """Token embeddings (+ stub-frontend prefix), positions and the
        prefix's length."""
        x = self._embed(batch["tokens"])
        n_front = 0
        if self.cfg.frontend == "patch" and "patch_embeds" in batch:
            n_front = batch["patch_embeds"].shape[1]
            x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
        B, S = x.shape[:2]
        return (shard(x, "act"),
                torch.arange(S, device=x.device)[None].expand(B, -1), n_front)

    def loss_fn(self, batch):
        """(loss, metrics) as the reference's ``loss_fn``: token-level
        cross-entropy of a float32 log-softmax over the padded vocabulary
        (the padded columns included), labels of -1 masked, the VLM
        stub's patch prefix cut before the logits, plus
        ``router_aux_weight`` times the MoE aux loss (summed over the
        layers, float32; 0 without MoE layers).  Metrics: ``ce``, ``aux``
        and ``ntok``.  An encoder-decoder model encodes
        ``batch["src_embeds"]`` first.  With ``cfg.remat`` each layer runs
        under ``torch.utils.checkpoint.checkpoint`` (its activations
        recomputed in the backward, as the reference's ``jax.checkpoint``
        with ``nothing_saveable``)."""
        cfg = self.cfg
        x, pos, n_front = self._prep_inputs(batch)
        memory = self._memory(batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for group in self.groups:
            for layer in group:
                x, a = self._run(layer, x, pos, memory=memory)
                if a is not None:
                    aux = aux + a
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        if n_front:
            x = x[:, n_front:]
        logits = self._logits(x)
        labels = batch["labels"]
        mask = (labels >= 0).float()
        lab = labels.clamp(min=0).long()
        # On DTensors each rank takes its rows and vocabulary shard
        # (``label_logp``): the vocabulary is never gathered.
        ll = label_logp(logits, lab)
        ntok = mask.sum().clamp(min=1.0)
        ce = -(ll * mask).sum() / ntok
        loss = ce + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux, "ntok": ntok}

    @torch.no_grad()
    def prefill(self, batch, cache_len: int,
                capacity_factor: float | None = None):
        """Logits [B, Vp] (float32) of the last position, and the caches:
        one (nested) dict per group, each leaf the group's layers' caches
        stacked on a leading axis (``[n, B, cache_len, Hkv, hd]`` for
        attention).  An encoder-decoder model encodes
        ``batch["src_embeds"]`` and each decoder layer's cache also holds
        the memory's cross-attention K and V.  ``capacity_factor``
        overrides the config's in the MoE layers (e.g. ``E / K``: a
        dropless prefill)."""
        x, pos, _ = self._prep_inputs(batch)
        memory = self._memory(batch)
        caches = []
        for group in self.groups:
            per, stacked = [], None
            for i, layer in enumerate(group):
                x, c = layer.prefill(x, pos, cache_len, memory,
                                     capacity_factor)
                if _any_dtensor(c):
                    per.append(c)
                else:
                    stacked = _into_slot(stacked, c, i, len(group))
                del c
            caches.append(tree_stack(per) if per else stacked)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x[:, -1:])[:, 0], caches

    @torch.no_grad()
    def decode_step(self, batch, caches):
        """Logits [B, Vp] of the next token.  Layer i of a group reads and
        writes slice i of the group's stacked caches in place (the
        reference carries them through its loop and updates them with
        ``dynamic_update_index_in_dim``).  An encoder-decoder model's
        cross-attention reads ``batch["mem_len"]`` positions of each row's
        memory."""
        x = self._embed(batch["tokens"])
        mem_len = batch.get("mem_len")
        for group, cs in zip(self.groups, caches):
            for i, layer in enumerate(group):
                x = layer.decode(x, tree_index(cs, i), batch["lengths"],
                                 mem_len)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x)[:, 0]

    def init_cache(self, B: int, cache_len: int, mem_len: int = 0) -> list:
        """Zeroed caches for B rows; ``mem_len`` sizes an encoder-decoder
        model's cross caches."""
        caches = []
        for group in self.groups:
            one = group[0].init_cache(B, cache_len, mem_len)
            caches.append(tree_map(
                lambda t, n=len(group): t.new_zeros(n, *t.shape), one))
        return caches


def _any_dtensor(tree) -> bool:
    if isinstance(tree, dict):
        return any(_any_dtensor(v) for v in tree.values())
    return isinstance(tree, DTensor)


def _into_slot(stacked, cache, i: int, n: int):
    """Layer i's cache written into slot i of its group's stacked caches
    (made, at layer 0, in the shapes of its cache), so that a prefill
    holds the stacked caches and one layer's: stacking every layer's
    cache at the end held two copies (llava-next-34b's 8-row prefill at
    4096 positions: 16.1 GB beside 68.8 GB of weights).  DTensor caches
    are stacked at the end (``torch.stack`` keeps their layouts, where
    ``new_empty`` of another shape would replicate them)."""
    if stacked is None:
        stacked = tree_map(lambda t: t.new_empty(n, *t.shape), cache)
    tree_map(lambda s, t: s[i].copy_(t), stacked, cache)
    return stacked


def _stack(plan: list, cfg: LMConfig, device, gen) -> nn.ModuleList:
    """One ``ModuleList`` of layers per (kind, count) group of ``plan``."""
    return nn.ModuleList(
        nn.ModuleList(Layer(kind, cfg, device, gen) for _ in range(n))
        for kind, n in plan)
