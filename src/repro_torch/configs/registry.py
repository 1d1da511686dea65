"""Assigned-architecture registry: exact configs and shapes.

A copy of ``repro.configs.registry`` as data: the ten ``ARCHS`` entries,
the four ``SHAPES`` and the eligibility rule, equal field for field to
the reference's.  Every architecture is a selectable config
(``--arch <id>``); ``long_500k`` needs sub-quadratic attention, so only
the bounded-state archs (falcon-mamba-7b, recurrentgemma-9b) run it.

``input_specs`` and ``cache_specs`` give every model input and the
decode caches as tensors of the reference's shapes and dtypes on a given
device, by default ``"meta"`` (nothing allocated); the dry run
(``launch.dryrun``) makes them under a ``FakeTensorMode``, where they are
fake tensors.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..models.config import LMConfig

# ---------------------------------------------------------------------------
# Shapes (assignment): (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# The 10 assigned architectures — exact published configs.
# ---------------------------------------------------------------------------

ARCHS: dict[str, LMConfig] = {
    # [hybrid] RG-LRU + local attn 1:2 (griffin pattern r,r,a) —
    # [arXiv:2402.19427]
    "recurrentgemma-9b": LMConfig(
        name="recurrentgemma-9b", family="hybrid", n_layers=38,
        d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288, vocab=256_000,
        head_dim=256, pattern="rra", window=2048, d_rnn=4096,
        tie_embeddings=True),
    # [dense] llama-arch small — [hf:HuggingFaceTB/SmolLM-360M]
    "smollm-360m": LMConfig(
        name="smollm-360m", family="dense", n_layers=32, d_model=960,
        n_heads=15, n_kv_heads=5, d_ff=2560, vocab=49_152,
        tie_embeddings=True),
    # [dense] qk_norm, GQA — [hf:Qwen/Qwen3-1.7B]
    "qwen3-1.7b": LMConfig(
        name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048,
        n_heads=16, n_kv_heads=8, d_ff=6144, vocab=151_936, head_dim=128,
        qk_norm=True, rope_theta=1_000_000.0),
    # [dense] GQA, QKV bias — [hf:Qwen/Qwen2.5-3B]
    "qwen2.5-3b": LMConfig(
        name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
        n_heads=16, n_kv_heads=2, d_ff=11_008, vocab=151_936,
        qkv_bias=True, rope_theta=1_000_000.0),
    # [dense] llama2-arch small — [arXiv:2401.02385]
    "tinyllama-1.1b": LMConfig(
        name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
        n_heads=32, n_kv_heads=4, d_ff=5632, vocab=32_000),
    # [ssm] mamba-1, attn-free — [arXiv:2410.05355]
    "falcon-mamba-7b": LMConfig(
        name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=65_024, ssm_state=16,
        ssm_conv=4, ssm_expand=2),
    # [moe] 8 experts top-2 — [hf:xai-org/grok-1]
    "grok-1-314b": LMConfig(
        name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=32_768, vocab=131_072, head_dim=128,
        n_experts=8, top_k=2, softcap=30.0),
    # [moe] kimi/moonlight 64e top-6 — [hf:moonshotai/Moonlight-16B-A3B]
    "moonshot-v1-16b-a3b": LMConfig(
        name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=1408, vocab=163_840,
        n_experts=64, top_k=6),
    # [audio] enc-dec, multimodal (frontend STUB) — [arXiv:2308.11596]
    "seamless-m4t-medium": LMConfig(
        name="seamless-m4t-medium", family="encdec", n_layers=12,
        n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
        vocab=256_206, frontend="audio"),
    # [vlm] anyres tiling (frontend STUB) — [hf:llava-next-34b]
    "llava-next-34b": LMConfig(
        name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=20_480, vocab=64_000, head_dim=128,
        frontend="patch", n_frontend_tokens=576),
}

# VLM family reuses the dense decoder plan.
ARCHS["llava-next-34b"] = dataclasses.replace(
    ARCHS["llava-next-34b"], family="dense", frontend="patch")
_VLM_IDS = {"llava-next-34b"}


def get_config(arch: str) -> LMConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    return ARCHS[arch]


def eligible_shapes(arch: str) -> list[str]:
    cfg = get_config(arch)
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.bounded_state:
        out.append("long_500k")
    return out


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in eligible_shapes(a)]


# ---------------------------------------------------------------------------
# Input specs (tensors without data: "meta", or fake under FakeTensorMode)
# ---------------------------------------------------------------------------

def input_specs(arch: str, shape: str, *, batch_override: int | None = None,
                device="meta") -> dict:
    """Every model input of the cell (arch, shape) as a tensor on
    ``device``, the reference's shapes and dtypes: train ``tokens`` and
    ``labels`` [B, S] int32, prefill ``tokens``, decode ``tokens`` [B, 1]
    and ``lengths`` [B] int32; plus ``patch_embeds`` [B, P, D] for the VLM
    stub, and ``src_embeds`` [B, S, D] (train, prefill) or ``mem_len``
    [B] int32 (decode) for the encoder-decoder, in the model dtype."""
    sh = SHAPES[shape]
    return make_inputs(get_config(arch), sh.kind,
                       batch_override or sh.global_batch, sh.seq_len, device)


def make_inputs(cfg: LMConfig, kind: str, B: int, S: int,
                device="meta") -> dict:
    """:func:`input_specs` for a config and a (kind, B, S), as zeros
    (valid token ids and lengths, so that a real tensor runs too)."""
    dt = getattr(torch, cfg.dtype)
    D = cfg.d_model

    def zeros(*size, dtype=torch.int32):
        return torch.zeros(size, dtype=dtype, device=device)

    if kind in ("train", "prefill"):
        spec = {"tokens": zeros(B, S)}
        if kind == "train":
            spec["labels"] = zeros(B, S)
        if cfg.frontend == "patch":
            spec["patch_embeds"] = zeros(B, cfg.n_frontend_tokens, D,
                                         dtype=dt)
        if cfg.family == "encdec":
            spec["src_embeds"] = zeros(B, S, D, dtype=dt)
        return spec
    # decode: one new token against a cache of S
    spec = {"tokens": zeros(B, 1), "lengths": zeros(B)}
    if cfg.family == "encdec":
        spec["mem_len"] = zeros(B)
    return spec


def cache_specs(arch: str, shape: str, *, batch_override: int | None = None,
                device="meta") -> list:
    """The decode caches of the cell as empty tensors on ``device``: what
    ``LM.init_cache`` makes (one nested dict a group, each leaf the
    group's layers stacked first), the reference's shapes and dtypes."""
    from ..models.model import LM

    cfg = get_config(arch)
    sh = SHAPES[shape]
    B = batch_override or sh.global_batch
    mem_len = sh.seq_len if cfg.family == "encdec" else 0
    caches = LM(cfg, device="meta").init_cache(B, sh.seq_len, mem_len)
    return _empty_like_tree(caches, device)


def _empty_like_tree(tree, device):
    if isinstance(tree, list):
        return [_empty_like_tree(t, device) for t in tree]
    if isinstance(tree, dict):
        return {k: _empty_like_tree(v, device) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device=device)
