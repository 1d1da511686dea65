"""Launch the CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

:func:`rglru_scan` is the wrapper: it checks its inputs, then on CUDA
tensors launches the kernel on the current stream (raising if the build or
the launch fails; there is no fallback), and on CPU tensors calls the plain
version ``ref.rglru_ref``.  Where autograd records the call (grad mode on
and an operand requiring a gradient) the wrapper goes through
:class:`RGLRUScan`, whose backward is ``rglru_scan_bwd``'s kernel (the
plain ``ref.rglru_bwd_ref`` on CPU tensors).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from . import build, custom_ops, on_shards, ref
from . import rglru_scan_bwd as bwd
from .selective_scan import check_scan_inputs

# The kernel's geometry (csrc/rglru_scan.cu): channels a block (the
# walker warp's lanes), and steps a chunk (a stage of its ring).
BLOCK_CHANNELS = 32
CHUNK = 64

# Launches of the kernel (not of the plain version).
launches = 0


def rglru_scan(x: torch.Tensor, a: torch.Tensor,
               h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU recurrence: x, a [B, S, D] (one dtype, float32 or bfloat16),
    h0 [B, D] (float32; zeros by default) -> (every h [B, S, D] in x's
    dtype, h_final [B, D] float32); see ``ref.rglru_ref``.  DTensor
    operands run on each rank's shards (``on_shards``); fake tensors go
    to the custom op (``custom_ops``), which the dry run counts."""
    if isinstance(x, DTensor):
        return on_shards.rglru_scan(rglru_scan, x, a, h0)
    if not isinstance(x, torch.Tensor) or x.dim() != 3:
        raise ValueError("rglru_scan takes x [B, S, D]")
    B, S, D = x.shape
    ops_ = {"x": x, "a": a}
    if h0 is not None:
        ops_["h0"] = h0
    check_scan_inputs("rglru_scan", ops_,
                      {"x": (B, S, D), "a": (B, S, D), "h0": (B, D)},
                      ("x", "a"))
    if a.dtype != x.dtype:
        raise TypeError(f"rglru_scan takes x and a in one dtype, got "
                        f"{x.dtype} and {a.dtype}")
    if build.needs_grad(x, a, h0):
        return RGLRUScan.apply(x, a, h0)
    if custom_ops.is_fake(x):
        return custom_ops.rglru_scan(x, a, h0, False)[:2]
    if x.device.type == "cpu":
        return ref.rglru_ref(x, a, h0)
    return _launch(*_on_card(x, a, h0))[:2]


def _on_card(x, a, h0):
    """The operands contiguous, h0 zeros when None."""
    if h0 is None:
        h0 = torch.zeros(x.shape[0], x.shape[2], dtype=torch.float32,
                         device=x.device)
    return x.contiguous(), a.contiguous(), h0.contiguous()


def _launch(x, a, h0, states: bool = False):
    """(every h in x's dtype, h_final, with ``states`` every h in float32
    [B, S, D] (the output itself when x is float32), else None)."""
    global launches
    B, S, D = x.shape
    y = torch.empty_like(x)
    hf = torch.empty_like(h0)
    h32 = (torch.empty(B, S, D, dtype=torch.float32, device=x.device)
           if states and x.dtype != torch.float32 else None)
    if B and D:
        lib = build.load()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rglru_scan_fwd(
            x.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
            hf.data_ptr(), None if h32 is None else h32.data_ptr(), B, S, D,
            build.DTYPE_CODES[str(x.dtype)[6:]], x.device.index, stream)
        build.check_rc(lib, rc, "rglru_scan")
        launches += 1
    return y, hf, (y if states and h32 is None else h32)


class RGLRUScan(torch.autograd.Function):
    """The RG-LRU scan with its gradient: on CUDA tensors the forward
    kernel (writing every state in float32) and the backward kernel
    (``rglru_scan_bwd``), on CPU tensors ``ref.rglru_ref`` and
    ``ref.rglru_bwd_ref``.  Either output's gradient may be absent
    (zeros); dh0 is returned when h0 was given."""

    @staticmethod
    def forward(ctx, x, a, h0):
        ctx.set_materialize_grads(False)
        ctx.has_h0 = h0 is not None
        if custom_ops.is_fake(x):
            y, hf, h32 = custom_ops.rglru_scan(x, a, h0, True)
            ctx.save_for_backward(x, a, h0, custom_ops.optional(h32)
                                  if x.dtype != torch.float32 else y)
        elif x.device.type == "cpu":
            y, hf = ref.rglru_ref(x, a, h0)
            ctx.save_for_backward(x, a, h0, None)
        else:
            x, a, h0 = _on_card(x, a, h0)
            y, hf, h32 = _launch(x, a, h0, states=True)
            ctx.save_for_backward(x, a, h0, h32)
        return y, hf

    @staticmethod
    def backward(ctx, dy, dhf):
        x, a, h0, h32 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, da, dh0 = bwd.rglru_scan_bwd(x, a, h0, dy, dhf, states=h32)
        return dx, da, dh0 if ctx.has_h0 else None
