"""Launch the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

:func:`flash_attention` is the wrapper: it checks its inputs, then on CUDA
tensors launches the kernel on the current stream (raising if the build or
the launch fails; there is no fallback), and on CPU tensors calls the plain
version ``ref.attention_ref``.  The kernel reads q, k and v through their
strides (only the head dim must be contiguous; in bfloat16 every row must
start on 16 bytes), so the model's ``[B, S, H, d]`` activations go in
without a transpose or a copy.  bfloat16 runs on the tensor cores (P V
with P split into bf16 hi + lo parts), float32 on the CUDA cores.

Training goes through :class:`FlashAttention`, a
``torch.autograd.Function``: :func:`flash_attention` takes it whenever
grad mode is on and an operand requires a gradient.  Its forward keeps
each row's log-sum-exp (the kernel writes it beside the output, which
stays the same bits), and its backward is the backward kernel
(``flash_attention_bwd.py``, ``csrc/flash_attention_bwd.cu``) on CUDA
tensors, ``ref.attention_bwd_ref`` on CPU tensors.  There is no autograd
through the plain version on the card, and no fallback: the backward
raises if its kernel cannot build or launch.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from . import build, custom_ops, on_shards, ref
from . import flash_attention_bwd as bwd

# The head dims the kernel has template instances for.
HEAD_DIMS = (16, 32, 64, 128, 256)

# Launches of the kernel (not of the plain version), so a run can show that
# its main path went through the kernel.
launches = 0


def check_attention_inputs(name: str, tensors: dict, d: int) -> None:
    """Refuse what the attention kernels do not take: one dtype (float32
    or bfloat16) and one cuda or cpu device for every operand, a head dim
    in ``HEAD_DIMS``, and a contiguous last axis."""
    first = next(iter(tensors.values()))
    for key, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} takes torch.Tensors, got "
                            f"{type(x).__name__} for {key}")
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} takes float32 or bfloat16, got "
                            f"{x.dtype} for {key}")
        if x.dtype != first.dtype or x.device != first.device:
            raise ValueError(f"{name} takes operands of one dtype on one "
                             f"device, got {x.dtype} on {x.device} for "
                             f"{key}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} takes a contiguous head dim ({key})")
    if first.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, got {first.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} takes head dims {HEAD_DIMS}, got {d}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None,
                    softcap: float | None = None,
                    pos_offset: int | None = None) -> torch.Tensor:
    """GQA attention: q [B, Sq, Hq, d], k and v [B, Sk, Hkv, d] ->
    [B, Sq, Hq, d] in q's dtype.  Query i sits at ``pos_offset + i``
    (``Sk - Sq``, end-aligned, by default); see ``ref.attention_ref``.
    DTensor operands run on each rank's shards (``on_shards``); fake
    tensors go to the custom op (``custom_ops``), which the dry run
    counts."""
    if isinstance(q, DTensor):
        return on_shards.flash_attention(flash_attention, q, k, v, causal,
                                         window, scale, softcap, pos_offset)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes [B, S, H, d] operands, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, Hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} query heads do not group "
                         f"over {Hkv} KV heads")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    ops_ = {"q": q, "k": k, "v": v}
    check_attention_inputs("flash_attention", ops_, d)
    fake = custom_ops.is_fake(q)
    if q.device.type == "cuda" and q.dtype == torch.bfloat16 and not fake:
        for key, x in ops_.items():
            check_16_byte_rows("flash_attention", key, x)
    if build.needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, scale, softcap,
                                    pos_offset)
    if fake:
        return custom_ops.flash_attention(q, k, v, causal, window, scale,
                                          softcap, pos_offset, False)[0]
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, softcap=softcap,
                                 pos_offset=pos_offset)
    return _launch(q, k, v, causal, window, scale, softcap, pos_offset)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: on CUDA tensors the forward
    kernel (with its log-sum-exp) and the backward kernel, on CPU tensors
    ``ref.attention_ref`` and ``ref.attention_bwd_ref``.  The forward
    saves q, k, v, the output and the log-sum-exp [B, Hq, Sq] (float32)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, softcap, pos_offset):
        kw = dict(causal=causal, window=window, scale=scale, softcap=softcap,
                  pos_offset=pos_offset)
        if custom_ops.is_fake(q):
            out, lse = custom_ops.flash_attention(
                q, k, v, causal, window, scale, softcap, pos_offset, True)
        elif q.device.type == "cpu":
            out, lse = ref.attention_ref(q, k, v, return_lse=True, **kw)
        else:
            out, lse = _launch(q, k, v, causal, window, scale, softcap,
                               pos_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = bwd.flash_attention_bwd(q, k, v, out, dout, lse,
                                             **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def rows_16_byte_aligned(x: torch.Tensor) -> bool:
    """Whether every row of ``x`` (its contiguous last axis) starts on 16
    bytes: the base pointer and the stride in bytes of every other axis
    longer than 1 (a stride that is never stepped does not matter) are
    multiples of 16."""
    item = x.element_size()
    return x.data_ptr() % 16 == 0 and not any(
        n > 1 and st * item % 16
        for n, st in zip(x.shape[:-1], x.stride()[:-1]))


def check_16_byte_rows(name: str, key: str, x: torch.Tensor) -> None:
    """The bfloat16 kernels copy 16-byte pieces of each row with
    cp.async: raise unless :func:`rows_16_byte_aligned`."""
    if not rows_16_byte_aligned(x):
        raise ValueError(f"{name} takes 16-byte aligned rows in bfloat16 "
                         f"on the card ({key}: strides {x.stride()})")


def _launch(q, k, v, causal, window, scale, softcap, pos_offset,
            with_lse: bool = False):
    """The output, and with ``with_lse`` also the log-sum-exp
    [B, Hq, Sq] (float32) that the kernel writes beside it."""
    global launches
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty(B, Sq, Hq, d, dtype=q.dtype, device=q.device)
    lse = (torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel():
        lib = build.load()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            B, Sq, Sk, Hq, Hkv, d, build.DTYPE_CODES[str(q.dtype)[6:]],
            d ** -0.5 if scale is None else scale,
            0.0 if softcap is None else softcap, int(causal),
            -1 if window is None else window,
            Sk - Sq if pos_offset is None else int(pos_offset),
            q.device.index, stream)
        build.check_rc(lib, rc, "flash_attention")
        launches += 1
    return (out, lse) if with_lse else out
