"""Griffin recurrent block with RG-LRU (recurrentgemma-9b): the port of
``repro.models.rglru``.

Structure (Griffin / recurrentgemma)::

    x -> norm -> two branches:
      gate branch : linear(D, d_rnn) -> GeLU (tanh approximation)
      rec  branch : linear(D, d_rnn) -> causal conv(width 4) -> RG-LRU
    out = (rec * gate) @ out_proj

RG-LRU recurrence (per channel), with c = 8::

    r_t = sigmoid(u_t W_a)      i_t = sigmoid(u_t W_i)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

As in the reference, prefill rounds ``a`` and the gated input to the model
dtype before the scan (``kernels.ops.rglru_scan``: the CUDA kernel on the
card, the plain version on the CPU); decode steps with the float32 ``a``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..sharding.partition import matmul, shard
from .config import LMConfig
from .layers import dense_init, dtype_of, param, rms_norm, rms_norm_init
from .ssm import conv_causal

_C = 8.0


class RGLRU(nn.Module):
    """The parameters of one recurrent block (``rglru_init``): ``norm``,
    ``rg_in`` and ``rg_gate`` [D, R], ``rg_conv_w`` [W, R], ``rg_conv_b``,
    ``rg_a`` and ``rg_i`` [R, R] (float32), ``rg_lambda`` [R] (float32,
    so that sigmoid(Lambda)^c lies in (0.9, 0.999)) and ``rg_out``
    [R, D]."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        D, R, W = cfg.d_model, cfg.d_rnn_, cfg.conv_width
        dt = dtype_of(cfg)
        f32 = torch.float32
        u = torch.empty(R, dtype=f32, device=device)
        if gen is not None:
            u.uniform_(0.9 ** (1 / _C), 0.999 ** (1 / _C), generator=gen)
        self.norm = param(rms_norm_init(D, device))
        self.rg_in = param(dense_init(gen, D, R, dt, device))
        self.rg_gate = param(dense_init(gen, D, R, dt, device))
        self.rg_conv_w = param(dense_init(gen, W, R, dt, device, W ** -0.5))
        self.rg_conv_b = param(torch.zeros(R, dtype=dt, device=device))
        self.rg_a = param(dense_init(gen, R, R, f32, device, R ** -0.5))
        self.rg_i = param(dense_init(gen, R, R, f32, device, R ** -0.5))
        self.rg_lambda = param(torch.log(u / (1.0 - u)))
        self.rg_out = param(dense_init(gen, R, D, dt, device))


def _gates(p: RGLRU, u):
    """(a, gated input), both float32; the products with ``rg_a`` and
    ``rg_i`` run in full float32 (TF32 stays off)."""
    uf = u.float()
    r = torch.sigmoid(matmul(uf, p.rg_a))
    i = torch.sigmoid(matmul(uf, p.rg_i))
    a = torch.exp(-_C * F.softplus(p.rg_lambda)[None, None] * r)
    return a, i * uf


def _in(p: RGLRU, x, cfg: LMConfig, conv_state=None):
    """Norm, the GeLU gate, and the conv of the recurrent branch:
    (gate, u, the conv's new state).  ``jax.nn.gelu`` defaults to the tanh
    approximation."""
    h = rms_norm(x, p.norm, cfg.norm_eps)
    gate = F.gelu(matmul(h, p.rg_gate), approximate="tanh")
    u, conv_state = conv_causal(shard(matmul(h, p.rg_in), "act_inner"),
                                p.rg_conv_w,
                                p.rg_conv_b, conv_state)
    return gate, u, conv_state


def rglru_train(p: RGLRU, x, cfg: LMConfig, *, return_cache: bool = False):
    """x: [B, S, D] -> [B, S, D] (+ the cache {conv, h} when prefilling)."""
    gate, u, conv_state = _in(p, x, cfg)
    a, xin = _gates(p, u)
    hs, hT = ops.rglru_scan(xin.to(u.dtype), a.to(u.dtype))
    out = x + shard(matmul(hs.to(x.dtype) * gate, p.rg_out), "act")
    if not return_cache:
        return out
    return out, {"conv": conv_state, "h": shard(hT, "state")}


def rglru_decode(p: RGLRU, x, cache: dict, cfg: LMConfig):
    """One token: x [B, 1, D]; cache {conv [B, W-1, R], h [B, R]}, both
    written in place (the reference returns a new cache)."""
    gate, u, conv_state = _in(p, x, cfg, cache["conv"])
    a, xin = _gates(p, u)
    a0 = a[:, 0]
    hn = (a0 * cache["h"]
          + torch.sqrt(torch.clamp(1 - a0 * a0, min=0.0)) * xin[:, 0])
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(hn)
    return x + shard(matmul(hn[:, None].to(x.dtype) * gate, p.rg_out),
                     "act")


def rglru_cache_init(cfg: LMConfig, B: int, device) -> dict:
    return {
        "conv": torch.zeros(B, cfg.conv_width - 1, cfg.d_rnn_,
                            dtype=dtype_of(cfg), device=device),
        "h": torch.zeros(B, cfg.d_rnn_, dtype=torch.float32, device=device),
    }
