"""Plain PyTorch versions of the port's kernels (the ground truth in tests).

Each function here is the semantic specification its CUDA kernel must
match bit for bit; on a CPU tensor the kernel wrappers call these.
"""
from __future__ import annotations

import torch

INF_CUT = 1.0e8
_COUNT_CLIP = 1.0e30

# Calls of the plain FW version, so a run can show that its main path went
# through the kernel and never through this function.
calls = 0


def fw_counts_ref(W: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Floyd-Warshall distances + shortest-path counts.  W: [..., V, V].

    The same float32 operations in the same order as
    ``repro.kernels.ref.fw_counts_ref``: at pivot k, row k and column k
    are masked out; a strict improvement replaces D and N, a tie below
    ``INF_CUT`` adds ``min(n_ik * n_kj, 1e30)``; N is clipped at 1e30.
    """
    global calls
    calls += 1
    V = W.shape[-1]
    eye = torch.eye(V, dtype=torch.bool, device=W.device)
    D = W
    N = (torch.where((W < INF_CUT) & ~eye, 1.0, 0.0).to(W.dtype)
         + eye.to(W.dtype))
    idx = torch.arange(V, device=W.device)
    for k in range(V):
        dik = D[..., :, k:k + 1]
        dkj = D[..., k:k + 1, :]
        nik = N[..., :, k:k + 1]
        nkj = N[..., k:k + 1, :]
        cand = dik + dkj
        ncand = (nik * nkj).clamp_max(_COUNT_CLIP)
        notk = idx != k
        mask = notk[:, None] & notk[None, :]
        lt = (cand < D) & mask
        eq = (cand == D) & mask & (cand < INF_CUT)
        D = torch.where(lt, cand, D)
        N = torch.where(lt, ncand, N + torch.where(eq, ncand, 0.0))
        N = N.clamp_max(_COUNT_CLIP)
    return D, N
