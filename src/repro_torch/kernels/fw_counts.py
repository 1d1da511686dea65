"""Launch the CUDA FW-with-counts kernel (``csrc/fw_counts.cu``).

:func:`fw_counts` is the wrapper: it checks its input, then on a CUDA
tensor launches the kernel on the current stream (raising if the build or
the launch fails; there is no fallback), and on a CPU tensor calls the
plain version ``ref.fw_counts_ref``.  The library is built and bound by
:mod:`.build` at first use.
"""
from __future__ import annotations

import torch

from . import build, ref

# Shared memory holds row k and column k of D and N: 16 * V bytes, within
# the 232,448 bytes a block may have.
MAX_V = 232448 // 16

# Launches of the kernel (not of the plain version), so a run can show that
# its main path went through the kernel.
launches = 0


def check_fw_input(W, name: str, max_v: int | None = None) -> None:
    """Refuse what the FW kernels do not take: [V, V] or [B, V, V]
    contiguous float32 (with V <= ``max_v`` where given)."""
    if not isinstance(W, torch.Tensor):
        raise TypeError(f"{name} takes a torch.Tensor, got "
                        f"{type(W).__name__}")
    if W.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {W.dtype}")
    if W.dim() not in (2, 3) or W.shape[-1] != W.shape[-2]:
        raise ValueError(f"{name} takes [V, V] or [B, V, V], got "
                         f"{tuple(W.shape)}")
    if not W.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    if max_v is not None and W.shape[-1] > max_v:
        raise ValueError(f"{name} takes V <= {max_v}, got {W.shape[-1]}")
    if W.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, got {W.device}")


def fw_counts(W: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Floyd-Warshall distances + path counts: [(B,) V, V] -> (D, N)."""
    check_fw_input(W, "fw_counts", MAX_V)
    if W.device.type == "cpu":
        return ref.fw_counts_ref(W)
    return _launch(W)


def _launch(W: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    squeeze = W.dim() == 2
    W3 = W.unsqueeze(0) if squeeze else W
    B, V, _ = W3.shape
    D = torch.empty_like(W3)
    N = torch.empty_like(W3)
    if B and V:
        lib = build.load()
        stream = torch.cuda.current_stream(W.device).cuda_stream
        rc = lib.fw_counts_f32(W3.data_ptr(), D.data_ptr(), N.data_ptr(),
                               B, V, W.device.index, stream)
        build.check_rc(lib, rc, "fw_counts")
        launches += 1
    if squeeze:
        D, N = D[0], N[0]
    return D, N
