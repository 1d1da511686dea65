"""Plain PyTorch versions of the port's kernels (the ground truth in tests).

Each function here is the semantic specification of its CUDA kernel:
the FW and min-plus kernels must match it bit for bit, the attention and
scan kernels to a stated float32 tolerance (they sum or round their
multiply-adds in another order).  On a
CPU tensor the kernel wrappers call these.
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


def fw_counts_tiled_sched_ref(W: torch.Tensor, bt: int, blocks: int = 1,
                              seed: int | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The blocked FW kernel's work queue (``kernels/fw_schedule.py``) run
    on plain tensors, as ``blocks`` blocks of one persistent launch would
    run it.  Bit for bit equal to :func:`fw_counts_ref` for every ``bt``.

    Each block takes items in queue order.  A step of a block runs only
    once the kernel's wait before it holds (the counters of
    ``fw_schedule``); with ``seed`` a random runnable block takes each
    step (half the time the one holding the newest item, so that older
    items lag as far as the waits allow), else the first runnable one.  An
    item reads its tiles and snapshots at its load step and writes them at
    later steps, as the kernel does: a missing wait shows as a wrong
    result, a wait on a later item as a ``RuntimeError`` (no block can
    run).  Tiles live in a padded scratch
    between items; a tile's first item reads the padded W, its last (pivot
    block nb - 1) writes the output.  A items fuse phases 1 and 2: the
    diagonal tile and one panel tile stepped pivot by pivot, each recording
    its snapshots into buffer m % 3.
    """
    import random

    from . import fw_schedule as fs

    calls["fw_counts_tiled_sched_ref"] += 1
    squeeze = W.dim() == 2
    W3 = W.unsqueeze(0) if squeeze else W
    B, V, _ = W3.shape
    Vt = max(bt, -(-V // bt) * bt)
    nb = Vt // bt
    W0 = pad_isolated(W3, Vt)
    N0 = _init_counts(W0)
    D, N = W0.clone(), N0.clone()             # the scratch
    D_out, N_out = torch.empty_like(D), torch.empty_like(N)
    snap = W3.new_empty(3, 4, B, bt, Vt)      # rs_d, rs_n, cs_d, cs_n
    # Per placement and pivot block.
    a_loaded = [[0] * nb for _ in range(B)]
    b_done = [[0] * nb for _ in range(B)]
    ver = [[[0] * nb for _ in range(nb)] for _ in range(B)]
    nA, n_out = fs.n_a(nb), fs.n_outer(nb)
    q = fs.queue(B, nb)
    head = 0
    local = torch.arange(bt, device=W.device)

    def sl(t: int) -> slice:
        return slice(t * bt, (t + 1) * bt)

    def load(b, m, ti, tj):
        src = (W0, N0) if m == 0 else (D, N)
        return tuple(x[b, sl(ti), sl(tj)].clone() for x in src)

    def store(b, m, ti, tj, d, n):
        dst = (D_out, N_out) if m == nb - 1 else (D, N)
        dst[0][b, sl(ti), sl(tj)] = d
        dst[1][b, sl(ti), sl(tj)] = n

    def run_a(it):
        m, b = it.m, it.b
        panel = nb > 1
        is_row = it.i == m
        p = it.j if is_row else it.i
        yield lambda: ((m < 3 or b_done[b][m - 3] >= n_out)
                       and ver[b][m][m] >= m
                       and (not panel or ver[b][it.i][it.j] >= m))
        dd, dn = load(b, m, m, m)
        if panel:
            pd, pn = load(b, m, it.i, it.j)
        a_loaded[b][m] += 1
        yield lambda: True
        buf = m % 3
        for k in range(bt):
            rd, rn = dd[k, :].clone(), dn[k, :].clone()
            cd, cn = dd[:, k].clone(), dn[:, k].clone()
            notk = local != k
            dd, dn = _fw_step(dd, dn, cd[:, None], cn[:, None], rd[None, :],
                              rn[None, :], notk[:, None] & notk[None, :])
            if not panel:
                continue
            if is_row:
                od, on = pd[k, :].clone(), pn[k, :].clone()
                snap[buf, 0, b, k, sl(p)], snap[buf, 1, b, k, sl(p)] = od, on
                pd, pn = _fw_step(pd, pn, cd[:, None], cn[:, None],
                                  od[None, :], on[None, :], notk[:, None])
            else:
                od, on = pd[:, k].clone(), pn[:, k].clone()
                snap[buf, 2, b, k, sl(p)], snap[buf, 3, b, k, sl(p)] = od, on
                pd, pn = _fw_step(pd, pn, od[:, None], on[:, None],
                                  rd[None, :], rn[None, :], notk[None, :])
        if panel:
            store(b, m, it.i, it.j, pd, pn)
            ver[b][it.i][it.j] = m + 1
        if fs.keeps_diag(it, nb):
            yield lambda: a_loaded[b][m] >= nA
            store(b, m, m, m, dd, dn)
            ver[b][m][m] = m + 1

    def run_b(it):
        m, b = it.m, it.b
        yield lambda: (ver[b][it.i][m] >= m + 1 and ver[b][m][it.j] >= m + 1
                       and ver[b][it.i][it.j] >= m)
        buf = m % 3
        ad, an = (snap[buf, a, b, :, sl(it.i)].clone() for a in (2, 3))
        bd, bn = (snap[buf, a, b, :, sl(it.j)].clone() for a in (0, 1))
        d, n = load(b, m, it.i, it.j)
        yield lambda: True
        for k in range(bt):
            d, n = _fw_step(d, n, ad[k][:, None], an[k][:, None],
                            bd[k][None, :], bn[k][None, :])
        store(b, m, it.i, it.j, d, n)
        ver[b][it.i][it.j] = m + 1
        b_done[b][m] += 1

    holding = [-1] * blocks                   # each block's item

    def block(x):
        nonlocal head
        while True:
            yield lambda: True
            e, head = head, head + 1
            if e >= len(q):
                return
            holding[x] = e
            yield from (run_a if q[e].kind == "A" else run_b)(q[e])

    rng = random.Random(seed) if seed is not None else None
    gens = [block(x) for x in range(blocks)]
    pending = {x: next(g) for x, g in enumerate(gens)}
    while pending:
        runnable = [x for x, cond in pending.items() if cond()]
        if not runnable:
            raise RuntimeError("the FW work queue deadlocked")
        if rng is None:
            x = runnable[0]
        elif rng.random() < 0.5:
            x = max(runnable, key=lambda y: holding[y])
        else:
            x = rng.choice(runnable)
        try:
            pending[x] = next(gens[x])
        except StopIteration:
            del pending[x]
    D, N = D_out[:, :V, :V], N_out[:, :V, :V]
    if squeeze:
        D, N = D[0], N[0]
    return D, N


def minplus_ref(A: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor | None = None,
                k_chunk: int = 64) -> torch.Tensor:
    """Tropical matrix product with the Pallas kernel's ceiling:
    ``out[i, j] = min(1e9, min_k A[i, k] + B[k, j])`` for A [M, K] and
    B [K, N]; with C [M, N] the accumulator starts at ``min(1e9, C)``,
    which is ``torch.minimum(C, minplus_ref(A, B))`` bit for bit, since min
    is exact (APSP's fused step, as the kernel takes it).

    ``repro.kernels.minplus.minplus_tiled_pallas`` starts its accumulator
    at 1e9 (and pads with 1e9), so wherever every sum exceeds 1e9 it
    returns 1e9; ``repro.kernels.ref.minplus_ref`` has no such ceiling and
    returns the smallest sum.  This function follows the kernel.  APSP
    agrees either way, since it takes ``min(D, .)`` and 1e9 means no edge.
    A NaN operand gives NaN (``torch.minimum`` and ``amin`` propagate it,
    as ``jnp.minimum`` does): a NaN in A[i, :] makes row i NaN, one in
    B[:, j] column j, one in C[i, j] that entry.  Each sum is rounded once
    and ``min`` is exact, so the result does not depend on the order over
    k; K is walked in chunks of ``k_chunk`` to bound the [M, k_chunk, N]
    temporary.
    """
    calls["minplus_ref"] += 1
    M, N = A.shape[0], B.shape[1]
    out = torch.full((M, N), NO_EDGE, dtype=A.dtype, device=A.device)
    if C is not None:
        out = torch.minimum(out, C)
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
    squaring, ``D = min(D, D (min,+) D)``, each squaring one fused step
    (``minplus_ref(D, D, D)``)."""
    D = W
    for _ in range(apsp_squarings(W.shape[-1])):
        D = minplus_ref(D, D, D)
    return D


# ---------------------------------------------------------------------------
# Attention (prefill and decode).
# ---------------------------------------------------------------------------

def _softmax_masked(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with masked logits at -inf; a row with
    nothing left gives zeros (the reference's ``isnan -> 0``)."""
    p = torch.softmax(logits.masked_fill(~mask, -math.inf), dim=-1)
    return torch.nan_to_num(p, nan=0.0)


def _attention_mask(Sq: int, Sk: int, causal: bool, window: int | None,
                    pos_offset: int, device) -> torch.Tensor:
    """[Sq, Sk]: query i (at ``pos_offset + i``) sees key j."""
    qpos = torch.arange(Sq, device=device) + pos_offset
    kpos = torch.arange(Sk, device=device)
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None, softcap: float | None = None,
                  pos_offset: int | None = None, return_lse: bool = False):
    """GQA attention, as ``repro.kernels.ref.attention_ref`` computes it.

    q: [B, Sq, Hq, d]; k, v: [B, Sk, Hkv, d] with Hq % Hkv == 0 (query head
    h reads KV head h // (Hq / Hkv)).  Query i sits at position
    ``pos_offset + i`` (end-aligned, ``Sk - Sq``, by default); key j is
    seen where ``j <= pos`` (causal) and ``j > pos - window`` (window).
    Float32 math; the output has q's dtype.  With ``return_lse`` it
    returns (out, lse): lse [B, Hq, Sq] float32, each row's log-sum-exp
    of its seen (capped) logits, -inf for a row that sees no key (what
    the flash kernel leaves for the backward).
    """
    calls["attention_ref"] += 1
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = d ** -0.5 if scale is None else scale
    qh = q.reshape(B, Sq, Hkv, g, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if pos_offset is None:
        pos_offset = Sk - Sq
    mask = _attention_mask(Sq, Sk, causal, window, pos_offset, q.device)
    p = _softmax_masked(logits, mask)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = out.reshape(B, Sq, Hq, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(logits.masked_fill(~mask, -math.inf), dim=-1)
    return out, lse.reshape(B, Hq, Sq)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                      *, causal: bool = True, window: int | None = None,
                      scale: float | None = None,
                      softcap: float | None = None,
                      pos_offset: int | None = None) -> tuple:
    """The gradient of :func:`attention_ref` (dq, dk, dv), in the order of
    operations of the backward kernel (``csrc/flash_attention_bwd.cu``):
    from the forward's output ``o`` [B, Sq, Hq, d] and its log-sum-exp
    ``lse`` [B, Hq, Sq], and the output's gradient ``dout``,

    - s = scale q.k, z = s or ``softcap`` tanh(s / softcap);
    - P = exp(z - lse) where the mask sees the key and lse is finite, else
      0 (a row that sees no key has lse = -inf and zero gradients, as the
      reference's ``where(isnan(p), 0, p)``);
    - D = rowsum(dout o o), dP = dout.v, dZ = P (dP - D), dS = dZ (times
      1 - tanh^2(s / softcap) with a cap);
    - dv = P^T dout, dk = scale dS^T q, dq = scale dS k; a KV head's dk
      and dv sum over its query heads.

    Float32 math; each gradient in its operand's dtype.
    """
    calls["attention_bwd_ref"] += 1
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = d ** -0.5 if scale is None else scale
    if pos_offset is None:
        pos_offset = Sk - Sq
    qh = q.reshape(B, Sq, Hkv, g, d).float()
    gh = dout.reshape(B, Sq, Hkv, g, d).float()
    kf, vf = k.float(), v.float()
    z = torch.einsum("bqhgd,bkhd->bhgqk", qh, kf) * scale
    if softcap is not None:
        t = torch.tanh(z / softcap)
        z = softcap * t
    lse_h = lse.reshape(B, Hkv, g, Sq, 1)
    mask = _attention_mask(Sq, Sk, causal, window, pos_offset, q.device)
    seen = mask & torch.isfinite(lse_h)
    p = torch.where(seen, torch.exp(z - lse_h), 0.0)
    dsum = (dout.float() * o.float()).sum(-1)               # [B, Sq, Hq]
    dsum = dsum.reshape(B, Sq, Hkv, g).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bqhgd,bkhd->bhgqk", gh, vf)
    ds = p * (dp - dsum)
    if softcap is not None:
        ds = ds * (1.0 - t * t)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, gh)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qh) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    return (dq.reshape(B, Sq, Hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor, *,
                         scale: float | None = None,
                         window: int | None = None,
                         softcap: float | None = None,
                         return_lse: bool = False):
    """One-token GQA attention over a KV cache, as
    ``repro.kernels.ref.decode_attention_ref`` computes it.

    q: [B, Hq, d]; caches: [B, S, Hkv, d]; lengths: [B], the valid prefix
    of each row (the new token, at ``lengths - 1``, already written).  A
    row of length 0 gives zeros.  Float32 math; the output has q's dtype.
    With ``return_lse`` it returns (out, lse): lse [B, Hq] float32, each
    row's log-sum-exp of its seen (capped) logits, -inf for a row that
    sees no position.
    """
    calls["decode_attention_ref"] += 1
    B, Hq, d = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    scale = d ** -0.5 if scale is None else scale
    qh = q.reshape(B, Hkv, g, d).float()
    logits = torch.einsum("bhgd,bkhd->bhgk", qh, k_cache.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    kpos = torch.arange(S, device=q.device)[None]
    lengths = lengths.to(q.device)[:, None]
    mask = kpos < lengths
    if window is not None:
        mask &= kpos > lengths - 1 - window
    p = _softmax_masked(logits, mask[:, None, None])
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    out = out.reshape(B, Hq, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(logits.masked_fill(~mask[:, None, None],
                                             -math.inf), dim=-1)
    return out, lse.reshape(B, Hq)


def merge_decode_ref(outs: list, lses: list) -> torch.Tensor:
    """Decode outputs of a cache cut into pieces over its positions,
    merged into the uncut call's: each piece's output o_i [B, Hq, d] and
    log-sum-exp lse_i [B, Hq] (-inf for a piece whose row sees no
    position), M = max_i lse_i, w_i = e^(lse_i - M) (0 where lse_i =
    -inf), out = sum_i w_i o_i / sum_i w_i in float32, zeros where no
    piece sees a position; the output in the pieces' dtype.
    ``on_shards`` merges the ranks' pieces the same way, by all-reduces."""
    big = torch.stack(lses).amax(0)
    num = torch.zeros(outs[0].shape, dtype=torch.float32,
                      device=outs[0].device)
    den = torch.zeros_like(big)
    for o, lse in zip(outs, lses):
        w = torch.where(lse > -math.inf, torch.exp(lse - big), 0.0)
        num = num + w[..., None] * o.float()
        den = den + w
    return torch.where(den[..., None] > 0,
                       num / den.clamp(min=1e-30)[..., None],
                       0.0).to(outs[0].dtype)


def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, lengths: torch.Tensor,
                               *, n_split: int, scale: float | None = None,
                               window: int | None = None,
                               softcap: float | None = None) -> torch.Tensor:
    """:func:`decode_attention_ref` computed as the decode kernel splits
    it (flash-decoding), for the tests: the cache is cut into ``n_split``
    chunks of ``ceil(S / n_split)`` positions; each chunk gives a partial
    of the positions in it that the row sees (its max logit m, its sum
    l = sum e^(s - m) and its unnormalised accumulator a = sum e^(s - m) v),
    an empty chunk none (l = 0); the partials are merged in chunk order,
    ``out = sum_i a_i e^(m_i - M) / sum_i l_i e^(m_i - M)`` with M the
    largest m of a non-empty chunk, zeros where every chunk is empty.
    Equal to :func:`decode_attention_ref` up to float32 rounding."""
    calls["decode_attention_split_ref"] += 1
    B, Hq, d = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    scale = d ** -0.5 if scale is None else scale
    qh = q.reshape(B, Hkv, g, d).float()
    logits = torch.einsum("bhgd,bkhd->bhgk", qh, k_cache.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    kpos = torch.arange(S, device=q.device)[None]
    lengths = lengths.to(q.device)[:, None]
    mask = kpos < lengths
    if window is not None:
        mask &= kpos > lengths - 1 - window
    logits = logits.masked_fill(~mask[:, None, None], -math.inf)
    chunk = -(-S // n_split)
    ms, ls, accs = [], [], []
    for i in range(n_split):
        sl = slice(min(i * chunk, S), min((i + 1) * chunk, S))
        x = logits[..., sl]
        if x.shape[-1] == 0:
            continue
        m = x.amax(-1)
        p = torch.exp(x - torch.where(m.isfinite(), m, 0.0)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgk,bkhd->bhgd", p,
                                 v_cache[:, sl].float()))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    M = torch.where(l > 0, m, -math.inf).amax(0)
    f = torch.where(l > 0, torch.exp(m - torch.where(M.isfinite(), M, 0.0)),
                    0.0)
    L = (l * f).sum(0)
    A = (acc * f[..., None]).sum(0)
    out = torch.where(L[..., None] > 0, A / torch.where(L > 0, L, 1.0)[
        ..., None], 0.0)
    return out.reshape(B, Hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Recurrences (Mamba-1 selective scan, RG-LRU).
# ---------------------------------------------------------------------------

def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                       h0: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 diagonal selective scan, as
    ``repro.kernels.ref.selective_scan_ref`` computes it: a loop over the
    sequence in float32,

        h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t
        y_t = (h_t C_t).sum(N) + D * x_t

    x, dt: [Bt, S, Di]; A: [Di, N]; B, C: [Bt, S, N]; D: [Di]; h0:
    [Bt, Di, N] (zeros by default).  Returns (y [Bt, S, Di] in x's dtype,
    h_final [Bt, Di, N] float32).
    """
    calls["selective_scan_ref"] += 1
    Bt, S, Di = x.shape
    A, D = A.float(), D.float()
    h = (torch.zeros(Bt, Di, A.shape[-1], dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    ys = []
    for t in range(S):
        xt, dtt = xf[:, t], dtf[:, t]
        dA = torch.exp(dtt[..., None] * A[None])
        h = dA * h + (dtt * xt)[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]) + D[None] * xt)
    y = (torch.stack(ys, 1) if ys
         else x.new_zeros(Bt, 0, Di, dtype=torch.float32))
    return y.to(x.dtype), h


def rglru_ref(x: torch.Tensor, a: torch.Tensor,
              h0: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU recurrence, as ``repro.kernels.ref.rglru_ref`` computes
    it: a loop over the sequence in float32,

        h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t

    x, a: [B, S, D]; h0: [B, D] (zeros by default).  Returns (every h
    [B, S, D] in x's dtype, h_final [B, D] float32).
    """
    calls["rglru_ref"] += 1
    Bt, S, Dd = x.shape
    af = a.float()
    b = torch.sqrt(torch.clamp(1.0 - af ** 2, min=0.0)) * x.float()
    h = (torch.zeros(Bt, Dd, dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    hs = []
    for t in range(S):
        h = af[:, t] * h + b[:, t]
        hs.append(h)
    out = (torch.stack(hs, 1) if hs
           else x.new_zeros(Bt, 0, Dd, dtype=torch.float32))
    return out.to(x.dtype), h


def selective_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor,
                           A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                           D: torch.Tensor, h0: torch.Tensor | None,
                           dy: torch.Tensor,
                           dh_final: torch.Tensor | None = None) -> tuple:
    """The gradient of :func:`selective_scan_ref` from the output's
    gradient ``dy`` (x's shape) and the final state's ``dh_final``
    ([Bt, Di, N]; zeros when None), in float32.  With e_t = exp(dt_t A),
    the states h_t of the forward loop, and, walking t from S down to 1,
    G_t = dy_t C_t + e_{t+1} G_{t+1} (G_{S+1} e_{S+1} = dh_final):

        dC_t = sum_d h_t dy_t            dB_t = sum_d G_t dt_t x_t
        dx_t = D dy_t + dt_t sum_n G_t B_t
        ddt_t = sum_n G_t (A e_t h_{t-1} + x_t B_t)
        dA = sum_{b,t} G_t dt_t e_t h_{t-1}   dD = sum_{b,t} dy_t x_t
        dh0 = e_1 G_1

    Returns (dx in x's dtype, ddt, dA, dB, dC, dD, dh0), all but dx in
    float32."""
    calls["selective_scan_bwd_ref"] += 1
    Bt, S, Di = x.shape
    N = A.shape[-1]
    f32, dev = torch.float32, x.device
    A, D = A.float(), D.float()
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    dyf = dy.float()
    h = (torch.zeros(Bt, Di, N, dtype=f32, device=dev) if h0 is None
         else h0.float())
    hs = [h]
    for t in range(S):
        e = torch.exp(dtf[:, t, :, None] * A[None])
        h = e * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        hs.append(h)
    g = (torch.zeros(Bt, Di, N, dtype=f32, device=dev) if dh_final is None
         else dh_final.float())
    dx = torch.zeros(Bt, S, Di, dtype=f32, device=dev)
    ddt = torch.zeros_like(dx)
    dB = torch.zeros(Bt, S, N, dtype=f32, device=dev)
    dC = torch.zeros_like(dB)
    dA = torch.zeros(Di, N, dtype=f32, device=dev)
    for t in reversed(range(S)):
        e = torch.exp(dtf[:, t, :, None] * A[None])
        G = dyf[:, t, :, None] * Cf[:, t, None, :] + g
        eh = e * hs[t]
        dC[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dyf[:, t])
        dB[:, t] = torch.einsum("bdn,bd->bn", G, dtf[:, t] * xf[:, t])
        dx[:, t] = (D[None] * dyf[:, t]
                    + dtf[:, t] * (G * Bf[:, t, None, :]).sum(-1))
        ddt[:, t] = (G * (A[None] * eh + xf[:, t, :, None]
                          * Bf[:, t, None, :])).sum(-1)
        dA += (G * dtf[:, t, :, None] * eh).sum(0)
        g = e * G
    dD = (dyf * xf).sum((0, 1))
    return dx.to(x.dtype), ddt, dA, dB, dC, dD, g


def rglru_bwd_ref(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None,
                  dy: torch.Tensor, dh_final: torch.Tensor | None = None
                  ) -> tuple:
    """The gradient of :func:`rglru_ref` from the gradient ``dy`` of every
    h (x's shape) and ``dh_final`` ([B, D]; zeros when None), in float32.
    With s_t = sqrt(max(1 - a_t^2, 0)), the states h_t of the forward loop
    and, walking t from S down to 1, G_t = dy_t + a_{t+1} G_{t+1}
    (a_{S+1} G_{S+1} = dh_final):

        dx_t = G_t s_t      da_t = G_t (h_{t-1} + x_t s'_t)
        dh0 = a_1 G_1

    s' is what ``jax.grad`` of ``repro.kernels.ref.rglru_ref`` takes: -a/s
    where 1 - a^2 > 0; at 1 - a^2 = 0 the same -a/s = -a/0 (da = -inf
    sign(x G a), NaN where x G = 0, as sqrt's 0.5 / 0 there); NaN where
    1 - a^2 < 0 (sqrt's infinite slope at 0 times max's zero slope).
    Returns (dx, da in their operands' dtype, dh0 float32)."""
    calls["rglru_bwd_ref"] += 1
    Bt, S, Dd = x.shape
    f32, dev = torch.float32, x.device
    af, xf, dyf = a.float(), x.float(), dy.float()
    u = 1.0 - af * af
    s = torch.sqrt(torch.clamp(u, min=0.0))
    sp = torch.where(u >= 0, -af / s, math.nan)
    b = s * xf
    h = (torch.zeros(Bt, Dd, dtype=f32, device=dev) if h0 is None
         else h0.float())
    hs = [h]
    for t in range(S):
        h = af[:, t] * h + b[:, t]
        hs.append(h)
    g = (torch.zeros(Bt, Dd, dtype=f32, device=dev) if dh_final is None
         else dh_final.float())
    dx = torch.zeros(Bt, S, Dd, dtype=f32, device=dev)
    da = torch.zeros_like(dx)
    for t in reversed(range(S)):
        G = dyf[:, t] + g
        dx[:, t] = G * s[:, t]
        da[:, t] = G * (hs[t] + xf[:, t] * sp[:, t])
        g = af[:, t] * G
    return dx.to(x.dtype), da.to(a.dtype), g


# -- the scan kernels' orders of operations (for the tests) ----------------

# Lanes of a channel in csrc/selective_scan.cu; lane q holds states q and
# q + SSCAN_LANES.
SSCAN_LANES = 8
LOG2E = 1.4426950408889634


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf in float32: a * b + c rounded once (the product of two float32
    values is exact in float64; the sum is rounded to float64 first, which
    moves the result by at most one float32 ulp, and only at a tie)."""
    return (a.double() * b.double() + c.double()).float()


def lane_tree_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis (2^k lanes) in the selective-scan
    kernel's transpose-reduce order: the first round adds lanes half the
    width apart (l and l + L/2), the next lanes a quarter apart, ...: for
    8 lanes ((L0 + L4) + (L2 + L6)) + ((L1 + L5) + (L3 + L7))."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def selective_scan_kernel_order_ref(x: torch.Tensor, dt: torch.Tensor,
                                    A: torch.Tensor, B: torch.Tensor,
                                    C: torch.Tensor, D: torch.Tensor,
                                    h0: torch.Tensor | None = None
                                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`selective_scan_ref` in the order of operations of
    ``csrc/selective_scan.cu``, in float32 on the CPU: A prescaled once,
    A' = A log2(e); per step dA = 2^(dt A') (the kernel's ex2.approx adds
    at most 2 ulp to this), u = (dt x) B, h = fmaf(dA, h, u); lane q's
    partial fmaf(h[q + 8], C[q + 8], h[q] C[q]) (states past N are 0); the
    lanes summed by :func:`lane_tree_sum`; y = fmaf(D, x, sum)."""
    calls["selective_scan_kernel_order_ref"] += 1
    Bt, S, Di = x.shape
    N = A.shape[-1]
    width = 2 * SSCAN_LANES
    pad = (0, width - N)
    Ap = torch.nn.functional.pad(A.float(), pad) * LOG2E
    h = (torch.zeros(Bt, Di, N) if h0 is None else h0.float())
    h = torch.nn.functional.pad(h, pad)
    xf, dtf = x.float(), dt.float()
    Bf = torch.nn.functional.pad(B.float(), pad)
    Cf = torch.nn.functional.pad(C.float(), pad)
    Df = D.float()
    ys = []
    for t in range(S):
        d = dtf[:, t, :, None]                          # [Bt, Di, 1]
        dA = torch.exp2(d * Ap[None])
        u = (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        h = fma32(dA, h, u)
        c = Cf[:, t, None, :].expand_as(h)
        lo, hi = slice(0, SSCAN_LANES), slice(SSCAN_LANES, width)
        part = fma32(h[..., hi], c[..., hi], h[..., lo] * c[..., lo])
        ys.append(fma32(Df[None], xf[:, t], lane_tree_sum(part)))
    y = (torch.stack(ys, 1) if ys
         else x.new_zeros(Bt, 0, Di, dtype=torch.float32))
    return y.to(x.dtype), h[..., :N].contiguous()


def rglru_kernel_order_ref(x: torch.Tensor, a: torch.Tensor,
                           h0: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`rglru_ref` in the order of operations of
    ``csrc/rglru_scan.cu``, in float32 on the CPU: b = sqrt(max(1 - a a,
    0)) x for the whole chunk first (the producer warps), then the walk
    h = fmaf(a, h, b) (the walker warp)."""
    calls["rglru_kernel_order_ref"] += 1
    Bt, S, Dd = x.shape
    af = a.float()
    b = torch.sqrt(torch.clamp(1.0 - af * af, min=0.0)) * x.float()
    h = torch.zeros(Bt, Dd) if h0 is None else h0.float()
    hs = []
    for t in range(S):
        h = fma32(af[:, t], h, b[:, t])
        hs.append(h)
    out = (torch.stack(hs, 1) if hs
           else x.new_zeros(Bt, 0, Dd, dtype=torch.float32))
    return out.to(x.dtype), h
