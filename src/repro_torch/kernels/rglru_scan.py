"""Launch the CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

:func:`rglru_scan` is the wrapper: it checks its inputs, then on CUDA
tensors launches the kernel on the current stream (raising if the build or
the launch fails; there is no fallback), and on CPU tensors calls the plain
version ``ref.rglru_ref``.
"""
from __future__ import annotations

import torch

from . import build, ref
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
    dtype, h_final [B, D] float32); see ``ref.rglru_ref``."""
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
    if x.device.type == "cpu":
        return ref.rglru_ref(x, a, h0)
    build.refuse_grad("rglru_scan", x, a, h0)
    if h0 is None:
        h0 = torch.zeros(B, D, dtype=torch.float32, device=x.device)
    return _launch(x.contiguous(), a.contiguous(), h0.contiguous())


def _launch(x, a, h0):
    global launches
    B, S, D = x.shape
    y = torch.empty_like(x)
    hf = torch.empty_like(h0)
    if B and D:
        lib = build.load()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rglru_scan_fwd(
            x.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
            hf.data_ptr(), B, S, D, build.DTYPE_CODES[str(x.dtype)[6:]],
            x.device.index, stream)
        build.check_rc(lib, rc, "rglru_scan")
        launches += 1
    return y, hf
