"""Launch the CUDA FW-with-counts kernel (``csrc/fw_counts.cu``).

:func:`fw_counts` is the wrapper: it checks its input, then on a CUDA
tensor launches the kernel on the current stream (raising if the build or
the launch fails; there is no fallback), and on a CPU tensor calls the
plain version ``ref.fw_counts_ref``.  The kernel holds a placement in the
registers of a thread-block cluster up to ``ONCHIP_MAX_V`` and runs its
L2-resident loop above; the cluster size is its own choice of V.  The
library is built and bound by :mod:`.build` at first use.
"""
from __future__ import annotations

import torch

from . import build, ref

# Above ONCHIP_MAX_V the kernel's L2-resident path holds row k and column k
# of D and N in shared memory: 16 * V bytes, within the 232,448 bytes a
# block may have.
MAX_V = 232448 // 16
# The largest V whose D and N a 16-CTA cluster holds in registers
# (``kOnChipMaxV`` in the source).
ONCHIP_MAX_V = 512
# The cluster sizes the kernel takes (powers of two; 16 is Hopper's
# non-portable maximum).
CLUSTER_SIZES = (1, 2, 4, 8, 16)


def instance(V: int, C: int) -> tuple[int, int]:
    """The kernel instance that holds V in C CTAs, (RW, CC): rows of 16 a
    warp and columns of 32 a lane, each rounded up to the sizes the kernel
    is compiled for (``row_groups`` and ``chunks`` in the source)."""
    cc = -(-V // 32)
    cc = next(x for x in (2, 4, 8, 12, 16, 1 << 20) if cc <= x)
    rw = -(-(-(-V // C)) // 16)
    rw = next(x for x in (1, 2, 4, 8, 1 << 20) if rw <= x)
    return rw, cc


def cluster_fits(V: int, C: int) -> bool:
    """Whether C CTAs hold V on chip (``fits`` in the source): at most 32
    cells a thread."""
    rw, cc = instance(V, C)
    return V <= ONCHIP_MAX_V and cc * rw <= 32

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
    """Launches the kernel at the cluster size it picks for V."""
    return _call(W, "fw_counts_f32")


def launch_at_cluster(W: torch.Tensor, cluster: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """For measuring and testing only: the kernel at cluster size
    ``cluster`` (one of ``CLUSTER_SIZES`` with ``cluster_fits``), the
    measurement behind its own choice (``launch/kernel_compare.py
    --clusters``).  W on the card, V <= ``ONCHIP_MAX_V``."""
    check_fw_input(W, "fw_counts", ONCHIP_MAX_V)
    return _call(W, "fw_counts_cluster_f32", cluster)


def _call(W: torch.Tensor, entry: str, *extra: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    squeeze = W.dim() == 2
    W3 = W.unsqueeze(0) if squeeze else W
    B, V, _ = W3.shape
    D = torch.empty_like(W3)
    N = torch.empty_like(W3)
    if B and V:
        lib = build.load()
        stream = torch.cuda.current_stream(W.device).cuda_stream
        rc = getattr(lib, entry)(W3.data_ptr(), D.data_ptr(), N.data_ptr(),
                                 B, V, *extra, W.device.index, stream)
        build.check_rc(lib, rc, "fw_counts")
        launches += 1
    if squeeze:
        D, N = D[0], N[0]
    return D, N
