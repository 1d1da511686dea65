"""Launch the CUDA backward of the RG-LRU scan (``csrc/rglru_scan_bwd.cu``).

:func:`rglru_scan_bwd` is the wrapper that ``rglru_scan.RGLRUScan.backward``
calls: from the forward's operands, the gradient dy of every h and the
final state's dh_final, it returns (dx, da, dh0), dx and da in x's dtype and
dh0 in float32.  On CUDA tensors it launches the kernel on the current
stream (raising if the build or the launch fails; there is no fallback), on
CPU tensors it calls the plain version ``ref.rglru_bwd_ref``.  The kernel
reads h_{t-1} from every state in float32, which the forward kernel writes
when asked (``states``): the forward's own output is in x's dtype, too
coarse in bfloat16 for the gradient.
"""
from __future__ import annotations

import torch

from . import build, ref

# Launches of the backward, not of the plain version, so a run can show
# that its training path went through the kernel.
launches = 0


def rglru_scan_bwd(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None,
                   dy: torch.Tensor, dh_final: torch.Tensor | None, *,
                   states: torch.Tensor | None) -> tuple:
    """(dx, da, dh0) of the RG-LRU scan; x, a as ``rglru_scan.rglru_scan``
    takes them, h0 [B, D] (zeros when None), dy [B, S, D] in x's dtype,
    dh_final [B, D] (zeros when None).  ``states``: every h in float32
    [B, S, D], as ``rglru_scan._launch(..., states=True)`` returns it:
    required on the card, not used on the CPU (the plain version
    recomputes every state from h0).  Fake tensors go to the custom op
    (``custom_ops``)."""
    from . import custom_ops
    from .rglru_scan import _on_card
    from .selective_scan import check_scan_inputs

    B, S, D = x.shape
    ops_ = {"x": x, "a": a, "dy": dy}
    for key, t in (("h0", h0), ("dh_final", dh_final), ("states", states)):
        if t is not None:
            ops_[key] = t
    check_scan_inputs("rglru_scan_bwd", ops_,
                      {"x": (B, S, D), "a": (B, S, D), "dy": (B, S, D),
                       "h0": (B, D), "dh_final": (B, D),
                       "states": (B, S, D)}, ("x", "a", "dy"))
    if a.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError(f"rglru_scan_bwd takes x, a and dy in one dtype, "
                        f"got {x.dtype}, {a.dtype} and {dy.dtype}")
    if custom_ops.is_fake(x):
        return custom_ops.rglru_scan_bwd(x, a, h0, dy, dh_final, states)
    if x.device.type == "cpu":
        return ref.rglru_bwd_ref(x, a, h0, dy, dh_final)
    if states is None:
        raise ValueError("rglru_scan_bwd on the card needs the forward "
                         "kernel's float32 states (states=)")
    x, a, h0 = _on_card(x, a, h0)
    return _launch(x, a, dy.contiguous(), states.contiguous(), h0,
                   None if dh_final is None else dh_final.contiguous())


def _launch(x, a, dy, h32, h0, dhf):
    global launches
    B, S, D = x.shape
    dx = torch.empty_like(x)
    da = torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    if B and D:
        lib = build.load()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rglru_scan_bwd(
            x.data_ptr(), a.data_ptr(), dy.data_ptr(), h32.data_ptr(),
            h0.data_ptr(), None if dhf is None else dhf.data_ptr(),
            dx.data_ptr(), da.data_ptr(), dh0.data_ptr(), B, S, D,
            build.DTYPE_CODES[str(x.dtype)[6:]], x.device.index, stream)
        build.check_rc(lib, rc, "rglru_scan_bwd")
        launches += 1
    return dx, da, dh0
