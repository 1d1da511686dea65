"""Launch the CUDA min-plus (tropical) matrix product (``csrc/minplus.cu``).

:func:`minplus` is the wrapper: it checks its input, then on CUDA tensors
launches the kernel on the current stream (raising if the build or the
launch fails; there is no fallback), and on CPU tensors calls the plain
version (``ref.minplus_ref``).  :func:`apsp` squares with the fused step.
:func:`tile_fill` says how the kernel's tiles fill the card.
"""
from __future__ import annotations

import torch

from . import build, ref

# Launches of the kernel (not of the plain version).
launches = 0

# The kernel's tile (csrc/minplus.cu kBM x kBN), its threads a block and
# the blocks resident an SM (its launch bounds: 384 threads of up to 168
# registers fill an SM's 65 536).
TILE = (96, 96)
THREADS = 384
RESIDENT = 1
# SMs of an H100 SXM, for fills computed without a card.
H100_SMS = 132


def tile_fill(M: int, N: int, sms: int = H100_SMS) -> dict:
    """How the kernel's tiles for an [M, N] output fill ``sms`` SMs:
    ``tiles``, ``most`` (tiles on the busiest SM, the blocks dealt out
    evenly) and ``share`` = tiles / (sms * most)."""
    tiles = -(-M // TILE[0]) * -(-N // TILE[1])
    most = -(-tiles // sms)
    return {"tiles": tiles, "sms": sms, "resident": RESIDENT, "most": most,
            "share": tiles / (sms * most)}


def _check(A, B, C=None) -> None:
    named = (("A", A), ("B", B)) + ((("C", C),) if C is not None else ())
    for name, X in named:
        if not isinstance(X, torch.Tensor):
            raise TypeError(f"minplus takes torch.Tensors, got "
                            f"{type(X).__name__} for {name}")
        if X.dtype != torch.float32:
            raise TypeError(f"minplus takes float32, got {X.dtype} for "
                            f"{name}")
        if X.dim() != 2:
            raise ValueError(f"minplus takes 2-D operands, got "
                             f"{tuple(X.shape)} for {name}")
        if not X.is_contiguous():
            raise ValueError(f"minplus takes contiguous operands ({name})")
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"minplus: A {tuple(A.shape)} and B "
                         f"{tuple(B.shape)} do not chain")
    if C is not None and C.shape != (A.shape[0], B.shape[1]):
        raise ValueError(f"minplus: C {tuple(C.shape)} is not "
                         f"{(A.shape[0], B.shape[1])}")
    if (any(X.device != A.device for _, X in named)
            or A.device.type not in ("cuda", "cpu")):
        devices = ", ".join(str(X.device) for _, X in named)
        raise ValueError(f"minplus takes its operands on one cuda or cpu "
                         f"device, got {devices}")


def minplus(A: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor | None = None) -> torch.Tensor:
    """``out[i, j] = min(1e9, min_k A[i, k] + B[k, j])`` for A [M, K] and
    B [K, N] float32 (the Pallas kernel's ceiling; see
    ``ref.minplus_ref``); with C [M, N], ``min(1e9, C[i, j], ...)`` in the
    same launch.  NaN operands propagate."""
    _check(A, B, C)
    if A.device.type == "cpu":
        return ref.minplus_ref(A, B, C)
    return _launch(A, B, C)


def _launch(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor | None = None,
            out: torch.Tensor | None = None) -> torch.Tensor:
    global launches
    M, K = A.shape
    N = B.shape[1]
    if out is None:
        out = A.new_empty(M, N)
    if M and N:
        lib = build.load()
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.minplus_f32(A.data_ptr(), B.data_ptr(),
                             None if C is None else C.data_ptr(),
                             out.data_ptr(), M, N, K, A.device.index, stream)
        build.check_rc(lib, rc, "minplus")
        launches += 1
    return out


def apsp(W: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest distances of W [V, V] by ``ref.apsp_squarings(V)``
    squarings ``D = min(D, D (min,+) D)``, each one fused :func:`minplus`
    call (a kernel launch on the card) into one of two buffers in turn;
    W itself is never written."""
    _check(W, W)
    if W.shape[0] != W.shape[1]:
        raise ValueError(f"apsp takes a square W, got {tuple(W.shape)}")
    if W.device.type == "cpu":
        return ref.apsp_ref(W)
    bufs = (torch.empty_like(W), torch.empty_like(W))
    D = W
    for s in range(ref.apsp_squarings(W.shape[-1])):
        D = _launch(D, D, D, out=bufs[s % 2])
    return D
