"""Top-level model assembly: the port of ``repro.models.model``.

``LM(cfg, device, generator)`` is the reference's
``build_model(cfg).init(key)``: the parameters, on the card unless the
caller names another device, drawn from a ``torch.Generator``.  Its
methods are the reference's callables: ``prefill(batch, cache_len)`` ->
(logits, caches), ``decode_step(batch, caches)`` -> logits,
``init_cache(B, cache_len)`` and ``param_count()``.  Batches use the
reference's keys: prefill ``{"tokens": [B, S]}`` (+ ``"patch_embeds"``
[B, P, D] for the VLM stub), decode ``{"tokens": [B, 1], "lengths": [B]}``
with int32 lengths.  ``decode_step`` writes the new cache entries (K/V,
conv windows, recurrent states) into ``caches`` in place (the reference
returns new caches).  A group's cache is a dict of stacked tensors, nested
for a griffin super-block (``models.tree``).

The dense, VLM-stub, SSM (falcon-mamba) and hybrid (recurrentgemma)
decoders are ported; the encoder-decoder family (ROADMAP queue 1 item 15e)
and the training loss ``loss_fn`` (item 15d) wait for later slices.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.proxies import resolve_device
from .config import LMConfig
from .layers import dense_init, dtype_of, param, rms_norm, rms_norm_init
from .transformer import Layer
from .tree import tree_index, tree_map, tree_stack


class LM(nn.Module):
    """The parameters (``init_params``): ``embed`` [Vp, D], ``groups``
    (one ``ModuleList`` of :class:`~.transformer.Layer` per group of the
    layer plan), ``final_norm`` [D] and, unless tied, ``lm_head`` [D, Vp].
    Matrices in the config's dtype, norms in float32, as the reference
    keeps them.

    The numbers come from ``generator`` (a ``torch.Generator`` on
    ``device``; the reference draws from ``jax.random``, so the numbers
    differ, the distributions do not).  ``generator=None`` leaves them
    unset, e.g. for shapes on the meta device or before
    ``load_state_dict``."""

    def __init__(self, cfg: LMConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.family == "encdec":
            raise NotImplementedError(
                "the encoder-decoder family waits for the enc-dec slice "
                "(ROADMAP queue 1 item 15e)")
        dev = resolve_device(device)
        D, Vp = cfg.d_model, cfg.vocab_padded
        dt = dtype_of(cfg)
        self.cfg = cfg
        self.embed = param(dense_init(generator, Vp, D, dt, dev, D ** -0.5))
        self.groups = nn.ModuleList(
            nn.ModuleList(Layer(kind, cfg, dev, generator)
                          for _ in range(n))
            for kind, n in cfg.layer_plan())
        self.final_norm = param(rms_norm_init(D, dev))
        if not cfg.tie_embeddings:
            self.lm_head = param(dense_init(generator, D, Vp, dt, dev,
                                            D ** -0.5))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_count(self) -> int:
        return sum(t.numel() for t in self.parameters())

    def _embed(self, tokens):
        # sqrt(d_model) rounded to the model dtype first, as the reference
        # does (45.2548 is 45.25 in bfloat16).
        return self.embed[tokens] * torch.tensor(
            self.cfg.d_model ** 0.5, dtype=dtype_of(self.cfg),
            device=self.device)

    def _logits(self, x):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return (x @ head).float()

    def _prep_inputs(self, batch):
        """Token embeddings (+ stub-frontend prefix) and positions."""
        x = self._embed(batch["tokens"])
        if self.cfg.frontend == "patch" and "patch_embeds" in batch:
            x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
        B, S = x.shape[:2]
        return x, torch.arange(S, device=x.device)[None].expand(B, -1)

    @torch.no_grad()
    def prefill(self, batch, cache_len: int):
        """Logits [B, Vp] (float32) of the last position, and the caches:
        one (nested) dict per group, each leaf the group's layers' caches
        stacked on a leading axis (``[n, B, cache_len, Hkv, hd]`` for
        attention)."""
        x, pos = self._prep_inputs(batch)
        caches = []
        for group in self.groups:
            per = []
            for layer in group:
                x, c = layer.prefill(x, pos, cache_len)
                per.append(c)
            caches.append(tree_stack(per))
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x[:, -1:])[:, 0], caches

    @torch.no_grad()
    def decode_step(self, batch, caches):
        """Logits [B, Vp] of the next token.  Layer i of a group reads and
        writes slice i of the group's stacked caches in place (the
        reference carries them through its loop and updates them with
        ``dynamic_update_index_in_dim``)."""
        x = self._embed(batch["tokens"])
        for group, cs in zip(self.groups, caches):
            for i, layer in enumerate(group):
                x = layer.decode(x, tree_index(cs, i), batch["lengths"])
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x)[:, 0]

    def init_cache(self, B: int, cache_len: int) -> list:
        caches = []
        for group in self.groups:
            one = group[0].init_cache(B, cache_len)
            caches.append(tree_map(
                lambda t, n=len(group): t.new_zeros(n, *t.shape), one))
        return caches
