"""Mamba-1 block (falcon-mamba-7b): the port of ``repro.models.ssm``.

Structure (Mamba paper)::

    x -> in_proj -> (u, z)                u, z: [B, S, d_inner]
    u -> causal depthwise conv(width 4) -> silu
    (dt, B, C) = x_proj(u);  dt = softplus(dt_proj(dt) + bias)
    y = selective_scan(u, dt, A=-exp(A_log), B, C, D)
    out = (y * silu(z)) @ out_proj

Prefill runs the selective scan through ``kernels.ops`` (the CUDA kernel
on the card, the plain version on the CPU) once over the whole prompt: the
reference's ``_scan_chunked`` (chunks of 256 steps carrying the state) only
bounds what a Pallas block holds, and the chunks give the same numbers
since each carries the state exactly.  Decode is one plain step per token
that keeps (conv window, state) in the cache and writes both in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..sharding.partition import column_blocks, matmul, pointwise, shard
from .config import LMConfig
from .layers import dense_init, dtype_of, param, rms_norm, rms_norm_init


class Mamba(nn.Module):
    """The parameters of one Mamba-1 block (``mamba_init``): ``norm``,
    ``in_proj`` [D, 2 Di], ``conv_w`` [W, Di], ``conv_b``, ``x_proj``
    [Di, R + 2 N], ``dt_w`` [R, Di] and ``dt_b`` (float32), ``A_log``
    [Di, N] and ``Dskip`` (float32), ``out_proj`` [Di, D].  A is the
    S4D-real init, ``dt_b`` the inverse softplus of dt ~ logU(1e-3, 0.1)."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        D, Di, N, R = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
        W = cfg.ssm_conv
        dt = dtype_of(cfg)
        f32 = torch.float32
        u = torch.empty(Di, dtype=f32, device=device)
        if gen is not None:
            u.uniform_(generator=gen)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt_init = torch.exp(u * (hi - lo) + lo)
        self.norm = param(rms_norm_init(D, device))
        self.in_proj = param(dense_init(gen, D, 2 * Di, dt, device))
        self.conv_w = param(dense_init(gen, W, Di, dt, device, W ** -0.5))
        self.conv_b = param(torch.zeros(Di, dtype=dt, device=device))
        self.x_proj = param(dense_init(gen, Di, R + 2 * N, dt, device))
        self.dt_w = param(dense_init(gen, R, Di, f32, device, R ** -0.5))
        self.dt_b = param(dt_init + torch.log1p(-torch.exp(-dt_init)))
        self.A_log = param(torch.log(torch.arange(
            1, N + 1, dtype=f32, device=device)).expand(Di, N).clone())
        self.Dskip = param(torch.ones(Di, dtype=f32, device=device))
        self.out_proj = param(dense_init(gen, Di, D, dt, device))


def conv_causal(u, w, b, state=None):
    """Depthwise causal conv in u's dtype, the W shifted products summed in
    the reference's order (``F.conv1d`` would sum in float32).  u:
    [B, S, C]; w: [W, C]; state: [B, W - 1, C] (zeros by default).
    Returns (y [B, S, C], new state [B, W - 1, C])."""
    W, S = w.shape[0], u.shape[1]
    if state is None:
        state = u.new_zeros(u.shape[0], W - 1, u.shape[2])
    ext = torch.cat([state, u], dim=1)                      # [B, S+W-1, C]
    y = sum(ext[:, i:i + S] * w[i][None, None] for i in range(W))
    return y + b[None, None], ext[:, -(W - 1):]


def _ssm_params(p: Mamba, u, cfg: LMConfig):
    R, N = cfg.dt_rank_, cfg.ssm_state
    # ``x_proj``'s rows follow the split channels, so on DTensors the
    # product is a partial sum: summed here (the ``act`` layout), as XLA
    # sums it (DTensor 2.11 cannot carry it into ``dt_w``'s split output).
    dt_r, Bm, Cm = torch.split(shard(matmul(u, p.x_proj), "act"),
                               [R, N, N], dim=-1)
    dt = pointwise(F.softplus,
                   matmul(dt_r.float(), p.dt_w) + p.dt_b[None, None])
    A = -torch.exp(p.A_log)
    return dt, A, Bm.float(), Cm.float()


def _in(p: Mamba, x, cfg: LMConfig, conv_state=None):
    """Norm, in_proj, conv and silu: (u, z, the conv's new state)."""
    u, z = column_blocks(rms_norm(x, p.norm, cfg.norm_eps), p.in_proj, 2)
    u, conv_state = conv_causal(shard(u, "act_inner"), p.conv_w, p.conv_b,
                                conv_state)
    return F.silu(u), z, conv_state


def mamba_train(p: Mamba, x, cfg: LMConfig, *, return_cache: bool = False):
    """x: [B, S, D] -> [B, S, D] (+ the cache {conv, h} when prefilling)."""
    u, z, conv_state = _in(p, x, cfg)
    dt, A, Bm, Cm = _ssm_params(p, u, cfg)
    y, hT = ops.selective_scan(u, dt, A, Bm, Cm, p.Dskip)
    out = x + shard(matmul(y * F.silu(z), p.out_proj), "act")
    if not return_cache:
        return out
    return out, {"conv": conv_state, "h": shard(hT, "state")}


def mamba_decode(p: Mamba, x, cache: dict, cfg: LMConfig):
    """One token: x [B, 1, D]; cache {conv [B, W-1, Di], h [B, Di, N]},
    both written in place (the reference returns a new cache)."""
    u, z, conv_state = _in(p, x, cfg, cache["conv"])
    dt, A, Bm, Cm = _ssm_params(p, u, cfg)
    u0, dt0 = u[:, 0].float(), dt[:, 0]
    dA = torch.exp(dt0[..., None] * A[None])                 # [B, Di, N]
    hn = dA * cache["h"] + (dt0 * u0)[..., None] * Bm[:, 0, None, :]
    y = torch.einsum("bdn,bn->bd", hn, Cm[:, 0]) + p.Dskip[None] * u0
    y = y[:, None].to(x.dtype) * F.silu(z)
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(hn)
    return x + shard(matmul(y, p.out_proj), "act")


def mamba_cache_init(cfg: LMConfig, B: int, device) -> dict:
    return {
        "conv": torch.zeros(B, cfg.ssm_conv - 1, cfg.d_inner,
                            dtype=dtype_of(cfg), device=device),
        "h": torch.zeros(B, cfg.d_inner, cfg.ssm_state, dtype=torch.float32,
                         device=device),
    }
