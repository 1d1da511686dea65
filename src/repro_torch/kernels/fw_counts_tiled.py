"""Launch the blocked CUDA FW-with-counts kernel
(``csrc/fw_counts_tiled.cu``).

:func:`fw_counts_tiled` is the wrapper: it checks its input, then on a
CUDA tensor allocates the padded D and N and the panel snapshots and
launches the three-phase kernel sequence on the current stream (raising if
the build or a launch fails; there is no fallback), and on a CPU tensor
calls the plain version ``ref.fw_counts_tiled_ref``.
"""
from __future__ import annotations

import torch

from . import build, ref
from .fw_counts import check_fw_input

# The tile the kernel is compiled for (``BT`` in the source; why 64 is
# written there).
BT = 64

# Calls of the kernel sequence (not of the plain version), so a run can
# show that its main path went through the kernel.
launches = 0


def fw_counts_tiled(W: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked Floyd-Warshall distances + path counts with tile ``BT``:
    [(B,) V, V] -> (D, N), bit for bit equal to ``ref.fw_counts_ref``."""
    check_fw_input(W, "fw_counts_tiled")
    if W.device.type == "cpu":
        return ref.fw_counts_tiled_ref(W, BT)
    return _launch(W)


def _launch(W: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    squeeze = W.dim() == 2
    W3 = W.unsqueeze(0) if squeeze else W
    B, V, _ = W3.shape
    Vt = -(-V // BT) * BT
    D = W3.new_empty(B, Vt, Vt)
    N = W3.new_empty(B, Vt, Vt)
    if B and V:
        # Per-pivot snapshots, k-major: row panel [B, BT, Vt] (row k of
        # the pivot rows) and column panel [B, BT, Vt] (column k,
        # transposed).
        snaps = [W3.new_empty(B, BT, Vt) for _ in range(4)]
        lib = build.load()
        stream = torch.cuda.current_stream(W.device).cuda_stream
        rc = lib.fw_counts_tiled_f32(
            W3.data_ptr(), D.data_ptr(), N.data_ptr(),
            *(s.data_ptr() for s in snaps), B, V, Vt, W.device.index,
            stream)
        build.check_rc(lib, rc, "fw_counts_tiled")
        launches += 1
    if Vt != V:
        D, N = D[:, :V, :V].contiguous(), N[:, :V, :V].contiguous()
    if squeeze:
        D, N = D[0], N[0]
    return D, N
