"""Launch the CUDA backward of flash attention
(``csrc/flash_attention_bwd.cu``).

:func:`flash_attention_bwd` is the wrapper that
``flash_attention.FlashAttention.backward`` calls: from q, k, v, the
forward's output o and log-sum-exp lse and the output's gradient dO, it
returns (dq, dk, dv) in the operands' dtype.  On CUDA tensors it launches
the kernels on the current stream (raising if the build or the launch
fails; there is no fallback), on CPU tensors it calls the plain version
``ref.attention_bwd_ref``.  The kernels read every operand through its
strides (the last axis contiguous) and write contiguous gradients; they
use no atomics, so repeated calls give the same bits.  bfloat16 runs on
the tensor cores and copies 16-byte pieces of each row with cp.async, so
on the card q, k, v and o must have 16-byte aligned rows (as the
forward's operands and output do), and autograd's dO, the one operand the
port does not make itself, is copied when its rows are not.
"""
from __future__ import annotations

import torch

from . import build, ref

# Launches of the backward (one launch = the three kernels of one call),
# not of the plain version, so a run can show that its training path went
# through the kernel.
launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None,
                        softcap: float | None = None,
                        pos_offset: int | None = None) -> tuple:
    """(dq, dk, dv) of flash attention: q, o and dout [B, Sq, Hq, d], k
    and v [B, Sk, Hkv, d], lse [B, Hq, Sq] float32 (the forward's), the
    forward's options; see ``ref.attention_bwd_ref``.  Fake tensors go to
    the custom op (``custom_ops``)."""
    from . import custom_ops
    from .flash_attention import (check_16_byte_rows, check_attention_inputs,
                                  rows_16_byte_aligned)

    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    for key, x, shape in (("o", o, q.shape), ("dout", dout, q.shape),
                          ("v", v, k.shape)):
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"flash_attention_bwd: {key} "
                             f"{tuple(x.shape)} does not match "
                             f"{tuple(shape)}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd takes a float32 lse "
                         f"[{B}, {Hq}, {Sq}], got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    ops_ = {"q": q, "k": k, "v": v, "o": o}
    kw = dict(causal=causal, window=window, scale=scale, softcap=softcap,
              pos_offset=pos_offset)
    rows16 = (q.device.type == "cuda" and q.dtype == torch.bfloat16
              and not custom_ops.is_fake(q))
    if dout.stride(-1) != 1 or (rows16 and not rows_16_byte_aligned(dout)):
        dout = dout.clone(memory_format=torch.contiguous_format)
    check_attention_inputs("flash_attention_bwd", {**ops_, "dout": dout}, d)
    if rows16:
        for key, x in ops_.items():
            check_16_byte_rows("flash_attention_bwd", key, x)
    if custom_ops.is_fake(q):
        return custom_ops.flash_attention_bwd(q, k, v, o, dout, lse, **kw)
    if q.device.type == "cpu":
        return ref.attention_bwd_ref(q, k, v, o, dout, lse, **kw)
    if lse.device != q.device:
        raise ValueError("flash_attention_bwd takes lse on q's device")
    return _launch(q, k, v, o, dout, lse.contiguous(), **kw)


def _launch(q, k, v, o, dout, lse, *, causal, window, scale, softcap,
            pos_offset):
    global launches
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dq = torch.empty(B, Sq, Hq, d, dtype=q.dtype, device=q.device)
    dk = torch.empty(B, Sk, Hkv, d, dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() or dk.numel():
        dsum = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
        lib = build.load()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], *dout.stride()[:3],
            B, Sq, Sk, Hq, Hkv, d, build.DTYPE_CODES[str(q.dtype)[6:]],
            d ** -0.5 if scale is None else scale,
            0.0 if softcap is None else softcap, int(causal),
            -1 if window is None else window,
            Sk - Sq if pos_offset is None else int(pos_offset),
            q.device.index, stream)
        build.check_rc(lib, rc, "flash_attention_bwd")
        launches += 1
    return dq, dk, dv
