"""Launch the blocked CUDA FW-with-counts kernel
(``csrc/fw_counts_tiled.cu``).

:func:`fw_counts_tiled` is the wrapper: it checks its input, then on a
CUDA tensor allocates the outputs and launches the kernel once on the
current stream (raising if the build or the launch fails; there is no
fallback), and on a CPU tensor calls the plain version
``ref.fw_counts_tiled_ref``.  The kernel's scratch (the padded D and N,
the panel snapshots and the work-queue counters) is allocated once per
(device, stream) and grown when a call needs more; the kernel leaves the
counters zero, so a call does no other host work and no host sync.
"""
from __future__ import annotations

import torch

from . import build, ref
from .fw_counts import check_fw_input

# The tile the kernel is compiled for (``BT`` in the source; why 64 is
# written there).
BT = 64

# Columns of ``launch_traced``'s trace (``kTraceCols`` in the source).
TRACE_COLS = 10

# Calls of the kernel (not of the plain version), so a run can show that
# its main path went through the kernel.
launches = 0

# (device index, stream) -> (float32 scratch, int32 counters), flat.
_scratch: dict = {}


def scratch_sizes(B: int, Vt: int) -> tuple[int, int]:
    """Float32 and int32 elements of the kernel's scratch for B placements
    padded to Vt: D and N [B, Vt, Vt], the snapshots [3, 4, B, BT, Vt];
    per placement, by pivot block, the A items that loaded the diagonal
    and the B items done, and one version per tile; then the queue head
    and the count of blocks that left."""
    nb = Vt // BT
    return 2 * B * Vt * Vt + 12 * B * BT * Vt, B * (2 * nb + nb * nb) + 2


def queue_items(B: int, V: int) -> int:
    """Work items of one call (``kernels/fw_schedule.py``)."""
    nb = -(-V // BT)
    return B * nb * ((1 if nb == 1 else 2 * (nb - 1)) + (nb - 1) ** 2)


def _scratch_for(device: torch.device, stream: int, B: int, Vt: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    n_f, n_i = scratch_sizes(B, Vt)
    key = (device.index, stream)
    f, c = _scratch.get(key, (None, None))
    if f is None or f.numel() < n_f:
        f = torch.empty(n_f, dtype=torch.float32, device=device)
    if c is None or c.numel() < n_i:
        c = torch.zeros(n_i, dtype=torch.int32, device=device)
    _scratch[key] = (f, c)
    return f, c


def fw_counts_tiled(W: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked Floyd-Warshall distances + path counts with tile ``BT``:
    [(B,) V, V] -> (D, N), bit for bit equal to ``ref.fw_counts_ref``."""
    check_fw_input(W, "fw_counts_tiled")
    if W.device.type == "cpu":
        return ref.fw_counts_tiled_ref(W, BT)
    return _launch(W)


def _launch(W: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    D, N, _ = _call(W, traced=False)
    return D, N


def launch_traced(W: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For measuring and testing only: one launch that also returns its
    trace, int64 [``queue_items``, ``TRACE_COLS``]: for each work item,
    dequeued, waits met and done (global ns), the block that ran it, and
    the item as the kernel decoded it (kind 0 = A, 1 = B; m, b, i, j;
    whether it stores the diagonal), which ``fw_schedule.queue`` must
    match (``launch/kernel_compare.py --trace``).  W on the card."""
    check_fw_input(W, "fw_counts_tiled")
    return _call(W, traced=True)


def _call(W: torch.Tensor, traced: bool):
    global launches
    squeeze = W.dim() == 2
    W3 = W.unsqueeze(0) if squeeze else W
    B, V, _ = W3.shape
    D = torch.empty_like(W3)
    N = torch.empty_like(W3)
    trace = None
    if traced:
        trace = torch.zeros(queue_items(B, V), TRACE_COLS,
                            dtype=torch.int64, device=W.device)
    if B and V:
        Vt = -(-V // BT) * BT
        lib = build.load()
        stream = torch.cuda.current_stream(W.device).cuda_stream
        f, cnt = _scratch_for(W.device, stream, B, Vt)
        DN = B * Vt * Vt
        ptrs = [W3.data_ptr(), D.data_ptr(), N.data_ptr(), f.data_ptr(),
                f[DN:].data_ptr(), f[2 * DN:].data_ptr(), cnt.data_ptr()]
        if traced:
            rc = lib.fw_counts_tiled_traced_f32(
                *ptrs, trace.data_ptr(), B, V, Vt, W.device.index, stream)
        else:
            rc = lib.fw_counts_tiled_f32(*ptrs, B, V, Vt, W.device.index,
                                         stream)
        build.check_rc(lib, rc, "fw_counts_tiled")
        launches += 1
    if squeeze:
        D, N = D[0], N[0]
    return D, N, trace
