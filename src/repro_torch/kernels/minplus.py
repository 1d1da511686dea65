"""Launch the CUDA min-plus (tropical) matrix product (``csrc/minplus.cu``).

:func:`minplus` is the wrapper: it checks its input, then on CUDA tensors
launches the kernel on the current stream (raising if the build or the
launch fails; there is no fallback), and on CPU tensors calls the plain
version ``ref.minplus_ref``.  :func:`apsp` squares with it.
"""
from __future__ import annotations

import torch

from . import build, ref

# Launches of the kernel (not of the plain version).
launches = 0


def _check(A, B) -> None:
    for name, X in (("A", A), ("B", B)):
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
    if A.device != B.device or A.device.type not in ("cuda", "cpu"):
        raise ValueError(f"minplus takes both operands on one cuda or cpu "
                         f"device, got {A.device} and {B.device}")


def minplus(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = min(1e9, min_k A[i, k] + B[k, j])`` for A [M, K] and
    B [K, N] float32 (the Pallas kernel's ceiling; see
    ``ref.minplus_ref``)."""
    _check(A, B)
    if A.device.type == "cpu":
        return ref.minplus_ref(A, B)
    return _launch(A, B)


def _launch(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    global launches
    M, K = A.shape
    N = B.shape[1]
    out = A.new_empty(M, N)
    if M and N:
        lib = build.load()
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.minplus_f32(A.data_ptr(), B.data_ptr(), out.data_ptr(),
                             M, N, K, A.device.index, stream)
        build.check_rc(lib, rc, "minplus")
        launches += 1
    return out


def apsp(W: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest distances of W [V, V] by ``ref.apsp_squarings(V)``
    squarings ``D = min(D, D (min,+) D)``, each product a :func:`minplus`
    call (a kernel launch on the card)."""
    D = W
    for _ in range(ref.apsp_squarings(W.shape[-1])):
        D = torch.minimum(D, minplus(D, D))
    return D
