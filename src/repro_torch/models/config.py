"""Model configuration for the LM substrate (all 10 assigned architectures).

A copy of ``repro.models.config``, field for field, so a config compares
equal across the two packages.  One frozen dataclass covers every family:
dense / MoE / SSM (mamba-1) / hybrid (griffin) / encoder-decoder / VLM- and
audio-stub decoders.  The configs in ``repro_torch.configs`` instantiate
these with the exact published hyper-parameters; smoke tests use
``reduced()`` copies.

Fields the port reads differently: ``attn_impl`` is kept for the
comparison only (the port's kernels dispatch on the tensor's device, a
CUDA tensor to the kernel, a CPU tensor to the plain version);
``scan_layers`` only shapes the reference's XLA program (the port runs
its layers one after another, eagerly, and its dry run counts every
layer it runs, so it ignores the field too); ``remat`` makes ``LM.loss_fn``
recompute each layer in the backward
(``torch.utils.checkpoint.checkpoint``), as the reference's
``jax.checkpoint``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # attention flavor
    qk_norm: bool = False           # qwen3: RMSNorm on q and k per head
    qkv_bias: bool = False          # qwen2.5: bias on qkv projections
    softcap: float | None = None    # grok: tanh logit soft-capping
    rope_theta: float = 10000.0
    norm_eps: float = 1.0e-6
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)

    # hybrid (griffin / recurrentgemma): pattern of temporal-mixing blocks,
    # repeated; 'r' = RG-LRU recurrent block, 'a' = local-attention block.
    pattern: str = ""               # e.g. "rra"
    window: int = 0                 # local-attention window (0 = none)
    d_rnn: int = 0                  # RG-LRU width (0 -> d_model)
    conv_width: int = 4

    # encoder-decoder (seamless)
    n_enc_layers: int = 0

    # modality frontend STUB: precomputed embeddings prepended to the token
    # stream ('patch' for VLM anyres tiles, 'audio' for speech frames).
    frontend: str = ""              # "" | "patch" | "audio"
    n_frontend_tokens: int = 0

    # numerics / lowering
    dtype: str = "bfloat16"
    pad_heads_to: int = 0           # zero-pad q heads for clean TP sharding
    vocab_pad_to: int = 2048        # pad vocab for clean TP sharding
    remat: bool = True
    scan_layers: bool = True        # False -> unrolled (exact cost analysis)
    q_chunk: int = 0                # 0 -> unchunked attention
    # The reference's kernel selector, kept only so that the configs compare
    # field for field.  Dispatch ignores it: a CUDA tensor always takes the
    # kernel, a CPU tensor the plain version; setting it changes nothing.
    attn_impl: str = "auto"

    # ---------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def n_heads_p(self) -> int:
        """Padded query-head count (sharding-friendly; zero-padded heads are
        function-exact: zero wq columns → uniform attention → zero wo rows).
        Must stay a multiple of n_kv_heads (GQA grouping)."""
        if self.pad_heads_to and self.pad_heads_to > self.n_heads:
            assert self.pad_heads_to % max(self.n_kv_heads, 1) == 0
            return self.pad_heads_to
        return self.n_heads

    @property
    def vocab_padded(self) -> int:
        p = self.vocab_pad_to
        return -(-self.vocab // p) * p if p else self.vocab

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def d_rnn_(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def bounded_state(self) -> bool:
        """True if decode state does not grow with context (SSM / hybrid
        with windowed attention) — the long_500k eligibility criterion."""
        return self.family == "ssm" or (self.family == "hybrid"
                                        and self.window > 0)

    def layer_plan(self) -> list[tuple[str, int]]:
        """Homogeneous groups of layers to scan over: [(kind, count)].

        dense/moe/ssm: one group.  hybrid: superblocks of len(pattern)
        layers plus an explicit tail so arbitrary depths keep the exact
        published layer order (e.g. recurrentgemma-9b: 38 = 12*(r,r,a)+2r).
        """
        if self.family == "hybrid":
            p = len(self.pattern)
            n_super, tail = divmod(self.n_layers, p)
            plan = [("super", n_super)] if n_super else []
            for ch in self.pattern[:tail]:
                plan.append(("rec" if ch == "r" else "lattn", 1))
            return plan
        kind = {"dense": "attn", "moe": "moe", "ssm": "mamba",
                "encdec": "attn"}[self.family]
        return [(kind, self.n_layers)]

    def reduced(self, **over) -> "LMConfig":
        """Smoke-test copy: same family/flavors, tiny dimensions."""
        small = dict(
            n_layers=min(self.n_layers, 4 if self.family != "hybrid"
                         else max(len(self.pattern) + 1, 4)),
            d_model=128,
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=256,
            vocab=512,
            vocab_pad_to=128,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            window=min(self.window, 32) if self.window else 0,
            d_rnn=128 if self.d_rnn_ and self.family == "hybrid" else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_frontend_tokens=min(self.n_frontend_tokens, 16),
            dt_rank=8 if self.family == "ssm" else 0,
            dtype="float32",
            scan_layers=True,
            q_chunk=0,
            name=self.name + "-smoke",
        )
        small.update(over)
        return dataclasses.replace(self, **small)
