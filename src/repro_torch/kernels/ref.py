"""Plain PyTorch versions of the port's kernels (the ground truth in tests).

Each function here is the semantic specification its CUDA kernel must
match bit for bit; on a CPU tensor the kernel wrappers call these.
"""
from __future__ import annotations

import collections
import math

import torch

INF_CUT = 1.0e8
NO_EDGE = 1.0e9
_COUNT_CLIP = 1.0e30

# Calls of each plain version, by function name, so a run can show that its
# main path went through the kernels and never through these functions.
calls: collections.Counter = collections.Counter()


def _fw_step(D, N, a_d, a_n, b_d, b_n, mask=None):
    """One rank-1 pivot update, with the reference's operands in its order:
    a strict improvement replaces D and N, a tie below ``INF_CUT`` adds
    ``min(n_ik * n_kj, 1e30)``, and N is clipped at 1e30.  ``mask`` is the
    pivot's row/column exclusion, None where the update is known not to
    touch the pivot row or column."""
    cand = a_d + b_d
    ncand = (a_n * b_n).clamp_max(_COUNT_CLIP)
    lt = cand < D
    eq = (cand == D) & (cand < INF_CUT)
    if mask is not None:
        lt = lt & mask
        eq = eq & mask
    D = torch.where(lt, cand, D)
    N = torch.where(lt, ncand, N + torch.where(eq, ncand, 0.0))
    return D, N.clamp_max(_COUNT_CLIP)


def _init_counts(W: torch.Tensor) -> torch.Tensor:
    """N0: 1 on finite off-diagonal edges, plus the identity."""
    eye = torch.eye(W.shape[-1], dtype=torch.bool, device=W.device)
    return (torch.where((W < INF_CUT) & ~eye, 1.0, 0.0).to(W.dtype)
            + eye.to(W.dtype))


def fw_counts_ref(W: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Floyd-Warshall distances + shortest-path counts.  W: [..., V, V].

    The same float32 operations in the same order as
    ``repro.kernels.ref.fw_counts_ref``: at pivot k, row k and column k
    are masked out; a strict improvement replaces D and N, a tie below
    ``INF_CUT`` adds ``min(n_ik * n_kj, 1e30)``; N is clipped at 1e30.
    """
    calls["fw_counts_ref"] += 1
    V = W.shape[-1]
    D, N = W, _init_counts(W)
    idx = torch.arange(V, device=W.device)
    for k in range(V):
        notk = idx != k
        D, N = _fw_step(D, N, D[..., :, k:k + 1], N[..., :, k:k + 1],
                        D[..., k:k + 1, :], N[..., k:k + 1, :],
                        notk[:, None] & notk[None, :])
    return D, N


def pad_isolated(W: torch.Tensor, Vp: int) -> torch.Tensor:
    """[B, V, V] -> [B, Vp, Vp] with isolated nodes (zero diagonal, no
    edges) appended.  They never take part in a relaxation: every path
    through one costs at least ``NO_EDGE`` and ties there fail the
    ``INF_CUT`` test, so the real block of FW's result is unchanged."""
    B, V, _ = W.shape
    if Vp == V:
        return W
    out = torch.full((B, Vp, Vp), NO_EDGE, dtype=W.dtype, device=W.device)
    out[:, :V, :V] = W
    idx = torch.arange(V, Vp, device=W.device)
    out[:, idx, idx] = 0.0
    return out


def fw_counts_tiled_ref(W: torch.Tensor, bt: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked three-phase FW with path counts, tile ``bt``: the snapshot
    scheme of ``repro.kernels.minplus.fw_counts_tiled_pallas`` in plain
    PyTorch.  Bit for bit equal to :func:`fw_counts_ref` for every ``bt``.

    W is padded to a multiple of ``bt`` with isolated nodes.  For each
    pivot block, the bt pivots are replayed in order:

    1. on the diagonal block, masking the pivot's row and column and
       recording each pivot's row and column at its time (the snapshots);
    2. on the row panel (pivot rows, every column) with the diagonal
       column snapshot as the left operand, and on the column panel with
       the diagonal row snapshot as the right one, each recording its own
       snapshots;
    3. on every tile from the panel snapshots.

    Each phase works on its whole region at once (batch and tiles).  The
    cells of the diagonal block keep phase 1's result, and the panels
    phase 2's: N's tie accumulation is not idempotent, so a second
    replay there would count tied paths twice.
    """
    calls["fw_counts_tiled_ref"] += 1
    squeeze = W.dim() == 2
    W3 = W.unsqueeze(0) if squeeze else W
    B, V, _ = W3.shape
    Vt = max(bt, -(-V // bt) * bt)
    D = pad_isolated(W3, Vt)
    N = _init_counts(D)
    local = torch.arange(bt, device=W.device)
    # Snapshots: rd/cd of the diagonal block (row k, column k at pivot
    # k's time), rs/cs of the row and column panels.
    rdD, rdN, cdD, cdN = (W3.new_empty(B, bt, bt) for _ in range(4))
    rsD, rsN = W3.new_empty(B, bt, Vt), W3.new_empty(B, bt, Vt)
    csD, csN = W3.new_empty(B, Vt, bt), W3.new_empty(B, Vt, bt)
    for k0 in range(0, Vt, bt):
        blk = slice(k0, k0 + bt)
        # Phase 1: the diagonal block.
        dD, dN = D[:, blk, blk], N[:, blk, blk]
        for k in range(bt):
            rdD[:, k, :], rdN[:, k, :] = dD[:, k, :], dN[:, k, :]
            cdD[:, :, k], cdN[:, :, k] = dD[:, :, k], dN[:, :, k]
            notk = local != k
            dD, dN = _fw_step(dD, dN, dD[:, :, k:k + 1], dN[:, :, k:k + 1],
                              dD[:, k:k + 1, :], dN[:, k:k + 1, :],
                              notk[:, None] & notk[None, :])
        # Phase 2: the row panel (left operand: the diagonal column
        # snapshot) and the column panel (right operand: the diagonal row
        # snapshot).  Their diagonal tiles compute values nothing reads.
        rD, rN = D[:, blk, :], N[:, blk, :]
        cD, cN = D[:, :, blk], N[:, :, blk]
        for k in range(bt):
            rsD[:, k, :], rsN[:, k, :] = rD[:, k, :], rN[:, k, :]
            csD[:, :, k], csN[:, :, k] = cD[:, :, k], cN[:, :, k]
            notk = local != k
            rD, rN = _fw_step(rD, rN, cdD[:, :, k:k + 1], cdN[:, :, k:k + 1],
                              rD[:, k:k + 1, :], rN[:, k:k + 1, :],
                              notk[:, None])
            cD, cN = _fw_step(cD, cN, cD[:, :, k:k + 1], cN[:, :, k:k + 1],
                              rdD[:, k:k + 1, :], rdN[:, k:k + 1, :],
                              notk[None, :])
        rD[:, :, blk], rN[:, :, blk] = dD, dN
        cD[:, blk, :], cN[:, blk, :] = dD, dN
        # Phase 3: every tile replays the pivots from the panel snapshots;
        # the panels then take back their phase-2 values.
        for k in range(bt):
            D, N = _fw_step(D, N, csD[:, :, k:k + 1], csN[:, :, k:k + 1],
                            rsD[:, k:k + 1, :], rsN[:, k:k + 1, :])
        D[:, blk, :], N[:, blk, :] = rD, rN
        D[:, :, blk], N[:, :, blk] = cD, cN
    D, N = D[:, :V, :V], N[:, :V, :V]
    if squeeze:
        D, N = D[0], N[0]
    return D, N


def minplus_ref(A: torch.Tensor, B: torch.Tensor,
                k_chunk: int = 64) -> torch.Tensor:
    """Tropical matrix product with the Pallas kernel's ceiling:
    ``out[i, j] = min(1e9, min_k A[i, k] + B[k, j])`` for A [M, K] and
    B [K, N].

    ``repro.kernels.minplus.minplus_tiled_pallas`` starts its accumulator
    at 1e9 (and pads with 1e9), so wherever every sum exceeds 1e9 it
    returns 1e9; ``repro.kernels.ref.minplus_ref`` has no such ceiling and
    returns the smallest sum.  This function follows the kernel.  APSP
    agrees either way, since it takes ``min(D, .)`` and 1e9 means no edge.
    Each sum is rounded once and ``min`` is exact, so the result does not
    depend on the order over k; K is walked in chunks of ``k_chunk`` to
    bound the [M, k_chunk, N] temporary.
    """
    calls["minplus_ref"] += 1
    M, N = A.shape[0], B.shape[1]
    out = torch.full((M, N), NO_EDGE, dtype=A.dtype, device=A.device)
    for k0 in range(0, A.shape[1], k_chunk):
        s = A[:, k0:k0 + k_chunk, None] + B[None, k0:k0 + k_chunk, :]
        out = torch.minimum(out, s.amin(1))
    return out


def apsp_squarings(V: int) -> int:
    """ceil(log2(V - 1)) squarings cover every shortest path (at most
    V - 1 hops); at least one, and V = 2 counts as 3."""
    return max(1, math.ceil(math.log2(max(V - 1, 2))))


def apsp_ref(W: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest distances of W [V, V] by repeated min-plus
    squaring, ``D = min(D, D (min,+) D)``."""
    D = W
    for _ in range(apsp_squarings(W.shape[-1])):
        D = torch.minimum(D, minplus_ref(D, D))
    return D
