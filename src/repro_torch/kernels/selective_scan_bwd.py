"""Launch the CUDA backward of the selective scan
(``csrc/selective_scan_bwd.cu``).

:func:`selective_scan_bwd` is the wrapper that
``selective_scan.SelectiveScan.backward`` calls: from the forward's
operands, the output's gradient dy and the final state's dh_final, it
returns (dx, ddt, dA, dB, dC, dD, dh0), dx in x's dtype and the rest in
float32.  On CUDA tensors it launches the kernels on the current stream
(raising if the build or the launch fails; there is no fallback), on CPU
tensors it calls the plain version ``ref.selective_scan_bwd_ref``.  The
kernel recomputes each chunk's states from the state entering it, which
the forward kernel writes when asked (``states``); it sums across blocks
through scratch buffers in a fixed order, so repeated calls give the same
bits.
"""
from __future__ import annotations

import torch

from . import build, ref

# Launches of the backward (one launch = its two kernels), not of the
# plain version, so a run can show that its training path went through the
# kernel.
launches = 0
# Entries a (block, b, t) of the kernel's dB / dC scratch: dB then dC, 16
# states each; a block holds ``selective_scan_bwd_block_channels()``
# channels.
PARTIALS = 32


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                       h0: torch.Tensor | None, dy: torch.Tensor,
                       dh_final: torch.Tensor | None, *,
                       states: torch.Tensor | None) -> tuple:
    """(dx, ddt, dA, dB, dC, dD, dh0) of the selective scan; operands as
    ``selective_scan.selective_scan`` takes them, dy [Bt, S, Di] in x's
    dtype, dh_final [Bt, Di, N] (zeros when None).  ``states``: the state
    entering each chunk, as ``selective_scan._launch(..., states=True)``
    returns it: required on the card, not used on the CPU (the plain
    version recomputes every state from h0).  Fake tensors go to the
    custom op (``custom_ops``)."""
    from . import custom_ops
    from .selective_scan import CHUNK, _on_card, check_scan_inputs

    Bt, S, Di = x.shape
    N = A.shape[1]
    ops_ = {"x": x, "dt": dt, "A": A, "B": B, "C": C, "D": D, "dy": dy}
    shapes = {"x": (Bt, S, Di), "dt": (Bt, S, Di), "A": (Di, N),
              "B": (Bt, S, N), "C": (Bt, S, N), "D": (Di,),
              "dy": (Bt, S, Di), "h0": (Bt, Di, N), "dh_final": (Bt, Di, N),
              "states": (Bt, -(-S // CHUNK), Di, N)}
    for key, t in (("h0", h0), ("dh_final", dh_final), ("states", states)):
        if t is not None:
            ops_[key] = t
    check_scan_inputs("selective_scan_bwd", ops_, shapes,
                      ("x", "dt", "dy"))
    if dy.dtype != x.dtype:
        raise TypeError(f"selective_scan_bwd takes dy in x's dtype "
                        f"{x.dtype}, got {dy.dtype}")
    if custom_ops.is_fake(x):
        return tuple(custom_ops.selective_scan_bwd(
            x, dt, A, B, C, D, h0, dy, dh_final, states))
    if x.device.type == "cpu":
        return ref.selective_scan_bwd_ref(x, dt, A, B, C, D, h0, dy,
                                          dh_final)
    if states is None:
        raise ValueError("selective_scan_bwd on the card needs the forward "
                         "kernel's chunk states (states=)")
    x, dt, A, B, C, D, h0 = _on_card(x, dt, A, B, C, D, h0)
    return _launch(x, dt, A, B, C, D, states.contiguous(), dy.contiguous(),
                   None if dh_final is None else dh_final.contiguous())


def _launch(x, dt, A, B, C, D, hb, dy, dhf):
    global launches
    Bt, S, Di = x.shape
    N = A.shape[1]
    f32, dev = torch.float32, x.device
    dx = torch.empty_like(x)
    ddt = torch.empty(Bt, S, Di, dtype=f32, device=dev)
    dA = torch.zeros(Di, N, dtype=f32, device=dev)
    dB = torch.zeros(Bt, S, N, dtype=f32, device=dev)
    dC = torch.zeros_like(dB)
    dD = torch.zeros(Di, dtype=f32, device=dev)
    dh0 = torch.empty(Bt, Di, N, dtype=f32, device=dev)
    if Bt and Di:
        lib = build.load()
        nblk = -(-Di // lib.selective_scan_bwd_block_channels())
        part_bc = torch.empty(Bt, nblk, S, PARTIALS, dtype=f32, device=dev)
        part_a = torch.empty(Bt, Di, N, dtype=f32, device=dev)
        part_d = torch.empty(Bt, Di, dtype=f32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.selective_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), hb.data_ptr(), dy.data_ptr(),
            None if dhf is None else dhf.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dD.data_ptr(), dh0.data_ptr(), part_bc.data_ptr(),
            part_a.data_ptr(), part_d.data_ptr(), Bt, S, Di, N,
            build.DTYPE_CODES[str(x.dtype)[6:]],
            build.DTYPE_CODES[str(dt.dtype)[6:]], dev.index, stream)
        build.check_rc(lib, rc, "selective_scan_bwd")
        launches += 1
    return dx, ddt, dA, dB, dC, dD, dh0
