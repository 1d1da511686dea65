"""Seeded numpy inputs for holding the kernels against their plain versions.

Shared by the tests (``tests/test_torch_*.py``) and ``chip_smoke.py``, so
both check the kernels on the same inputs: random sparse graphs shaped like
``tests/test_kernels.py::random_graph``, graphs that are not connected, the
count-clip layered graph of ``tests/test_properties.py``, real score graphs
of the homogeneous archs (the paper's and the 100+-chiplet families),
min-plus operands with ragged shapes, and attention operands (the
``tests/test_kernels.py`` cases and more, and the edges of the attention
kernels' tiles and splits).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .kernels import ref

NO_EDGE = np.float32(1e9)


def random_graph(V: int, n_edges: int, seed: int = 0,
                 batch: int = 1) -> np.ndarray:
    """[batch, V, V] symmetric graphs with integer weights in [1, 8]."""
    rng = np.random.default_rng(seed)
    W = np.full((batch, V, V), NO_EDGE, np.float32)
    for b in range(batch):
        np.fill_diagonal(W[b], 0)
        for _ in range(n_edges):
            i, j = rng.integers(V, size=2)
            if i != j:
                w = float(rng.integers(1, 9))
                W[b, i, j] = min(W[b, i, j], w)
                W[b, j, i] = min(W[b, j, i], w)
    return W


def directed_graph(V: int, n_edges: int, seed: int = 0) -> np.ndarray:
    """[V, V] directed graph: one-way edges with integer weights in
    [1, 8] (W[i, j] need not equal W[j, i]), 0 on the diagonal."""
    rng = np.random.default_rng(seed)
    W = np.full((V, V), NO_EDGE, np.float32)
    np.fill_diagonal(W, 0)
    for _ in range(n_edges):
        i, j = rng.integers(V, size=2)
        if i != j:
            W[i, j] = min(W[i, j], float(rng.integers(1, 9)))
    return W


def disconnected_graph(V: int, seed: int = 0, batch: int = 1) -> np.ndarray:
    """Random graphs cut into two components (first half / second half)
    plus one isolated node, so D keeps 1e9 entries and N zeros."""
    W = random_graph(V, 3 * V, seed=seed, batch=batch)
    h = V // 2
    W[:, :h, h:] = NO_EDGE
    W[:, h:, :h] = NO_EDGE
    W[:, -1, :-1] = NO_EDGE
    W[:, :-1, -1] = NO_EDGE
    return W


def count_clip_graph(M: int = 10, K: int = 32) -> np.ndarray:
    """K layered stages of M parallel midpoints: M^(K-1) shortest paths
    from node 0 to node 1, far past the 1e30 count clip.  [V, V]."""
    V = 2 + (K - 1) * M
    W = np.full((V, V), NO_EDGE, np.float32)
    np.fill_diagonal(W, 0.0)

    def node(stage, m):
        if stage == 0:
            return 0
        if stage == K:
            return 1
        return 2 + (stage - 1) * M + m

    for s in range(K):
        for ma in range(M if s > 0 else 1):
            for mb in range(M if s < K - 1 else 1):
                W[node(s, ma), node(s + 1, mb)] = 1.0
    return W


# The 100+-chiplet homogeneous families (``chiplets.LARGE_HOMOG``).
LARGE_ARCHS = ("homog100", "homog144", "homog256", "hex127")


def score_graphs(arch_name: str, config: str, n: int,
                 seed: int = 5) -> np.ndarray:
    """[n, V, V] real score-graph weights of random placements of a
    homogeneous arch that ``resolve_arch`` knows (``HomogRep.random`` from
    a numpy seed)."""
    from .core.api import make_rep
    from .core.chiplets import resolve_arch
    arch = resolve_arch(arch_name, config)
    rep = make_rep(arch, arch_name)
    rng = np.random.default_rng(seed)
    return np.stack([rep.score_graph(rep.random(rng)).W for _ in range(n)])


GRAPH_KEYS = ("W", "edges", "edge_mask", "edge_len", "area")
# The archs whose batched score-graph builds ``chip_smoke.py`` holds against
# the host build on the card: the grid families (a hexagonal mask among
# them) through ``HomogGraphBatch``, the corner-placement families through
# ``HeteroBatch.geometry_batch`` and ``HeteroGraphBatch``.
PIPELINE_ARCHS = (("homog64", "placeit"), ("homog256", "placeit"),
                  ("hex127", "baseline"), ("hetero32", "placeit"),
                  ("hetero64", "placeit"))
# The 3D / hierarchical families (``repro_torch.arch3d``), each in the
# config its users run (the gateway family wants "placeit").
PIPELINE_ARCHS_3D = (("stack3d32", "baseline"), ("stack3d64", "placeit"),
                     ("gw3d64", "placeit"), ("torus3d32", "baseline"),
                     ("express3d32", "placeit"))


def _edge_sets(edges: np.ndarray, mask: np.ndarray) -> list:
    return [{(int(u), int(v)) for (u, v), m in zip(e, k) if m}
            for e, k in zip(edges, mask)]


def batched_build_parity(arch_name: str, config: str, n: int, *,
                         seed: int = 0, device="cpu", score: bool = True,
                         chunk: int = 16) -> dict:
    """Hold the batched score-graph build of ``n`` random placements (numpy
    seed ``seed``) on ``device`` against the host ``score_graph`` of each.

    Raises ``AssertionError`` unless every stacked array (W, edges,
    edge_mask, edge_len, area) is equal bit for bit, slot for slot, the
    directed edge sets are equal, and ``connected`` is equal (the hetero
    build's Borůvka flag, else the scorer's; the 3D families' host flag
    is a chiplet-level union-find, which the scorer's PHY-level
    reachability need not match, so it is not held there); the hetero
    build must flag no overflow.  A 3D family builds through its rep's
    ``graph_batch`` with the rep's tier vector as the runtime operand.
    With ``score`` the scorer's metrics and cost (on ``device``, its
    default FW) from the two builds must be bit-equal.
    Returns counts, the batched build's wall seconds (``build_s``, device
    synchronised) and for the hetero archs the host corner placement's
    before it (``geometry_s``)."""
    import time

    import torch

    from .core.api import make_rep
    from .core.chiplets import resolve_arch
    from .core.objective import Objective
    from .core.placement_hetero import HeteroRep
    from .core.proxies import make_scorer
    from .core.topology import (HeteroGraphBatch, HomogGraphBatch,
                                stack_graphs)
    dev = torch.device(device)
    arch = resolve_arch(arch_name, config)
    rep = make_rep(arch, arch_name)
    rng = np.random.default_rng(seed)
    sols = [rep.random(rng) for _ in range(n)]
    graphs = [rep.score_graph(s) for s in sols]
    host = stack_graphs(graphs)
    host_conn = np.array([g.connected for g in graphs])
    a = np.stack([s[0] for s in sols])
    b = np.stack([s[1] for s in sols])
    hetero = isinstance(rep, HeteroRep)
    grid3d = hasattr(rep, "graph_batch")
    if hetero:
        ops, gb = rep.batch_ops(dev), HeteroGraphBatch(arch, dev)
    elif grid3d:
        gb = rep.graph_batch(dev)
    else:
        gb = HomogGraphBatch(arch, rep.R, rep.C, area=rep.area, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    times = {}
    if hetero:
        t0 = time.perf_counter()
        ppos, area = ops.geometry_batch(a, b)
        times["geometry_s"] = time.perf_counter() - t0
        args = (torch.from_numpy(ppos).to(dev), torch.from_numpy(area).to(dev))
    else:
        args = (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
        if grid3d:
            args += (torch.as_tensor(rep.tier_values, device=dev),)
    sync()
    t0 = time.perf_counter()
    batch = gb.build(*args)
    sync()
    times["build_s"] = time.perf_counter() - t0
    got = {k: v.cpu().numpy() for k, v in batch.items()}
    where = f"{arch_name} {config}"
    if hetero:
        assert not got.pop("overflow").any(), f"{where}: overflow"
        conn = got.pop("connected")
        assert np.array_equal(conn, host_conn), f"{where}: connected"
    for k in GRAPH_KEYS:
        assert got[k].dtype == host[k].dtype, f"{where}: {k} dtype"
        assert np.array_equal(got[k], host[k]), f"{where}: {k} differs"
    assert _edge_sets(got["edges"], got["edge_mask"]) == _edge_sets(
        host["edges"], host["edge_mask"]), f"{where}: edge sets"
    out = {"n": n, "connected": int(host_conn.sum()),
           "links": float(host["edge_mask"].sum()) / 2 / n, **times}
    if score:
        scorer = make_scorer(rep.layout, chunk=chunk,
                             objective=Objective.from_arch(arch), device=dev)
        mine = {k: v for k, v in batch.items()
                if k not in ("connected", "overflow")}
        m_dev, m_host = scorer(mine), scorer(host)
        for k, v in m_host.items():
            assert np.array_equal(m_dev[k], v), f"{where}: metric {k}"
        if not hetero and not grid3d:
            assert np.array_equal(m_dev["connected"], host_conn), \
                f"{where}: scorer connected"
    return out


def kernel_cases() -> dict:
    """Named builders of [B, V, V] inputs (called on demand, so listing the
    cases costs nothing): random graphs for V in {5, 8, 13, 40, 130, 216,
    480} x B in {1, 3, 16}, disconnected graphs, the count-clip graph and
    score graphs of homog32 and homog64, baseline and placeit (V = 216,
    240, 432, 480)."""
    cases = {}
    for V in (5, 8, 13, 40, 130, 216, 480):
        for B in (1, 3, 16):
            cases[f"random V={V} B={B}"] = (
                lambda V=V, B=B: random_graph(V, 3 * V, seed=V + B, batch=B))
    for V in (13, 130):
        cases[f"disconnected V={V} B=3"] = (
            lambda V=V: disconnected_graph(V, seed=V, batch=3))
    cases["count-clip V=312"] = lambda: count_clip_graph()[None]
    for name in ("homog32", "homog64"):
        for cfg in ("baseline", "placeit"):
            cases[f"{name} {cfg} B=4"] = (
                lambda name=name, cfg=cfg: score_graphs(name, cfg, 4))
    return cases


def tiled_cases(bt: int) -> dict:
    """Named factories of [B, V, V] inputs for the blocked FW with tile
    ``bt``: random graphs with V at the tile edges (bt - 1, bt, bt + 1,
    2 bt + 3) x B in {1, 3, 16}, graphs that are not connected across
    tiles, the count-clip graph (V = 312: its shortest paths from node 0
    to node 1 cross every tile boundary) and real score graphs of the four
    100+-chiplet families at both configs (B = 2, V = 552 to 1536)."""
    cases = {}
    for V in (bt - 1, bt, bt + 1, 2 * bt + 3):
        for B in (1, 3, 16):
            cases[f"random V={V} B={B}"] = (
                lambda V=V, B=B: random_graph(V, 3 * V, seed=V + B, batch=B))
    for V in (bt + 1, 2 * bt + 3):
        cases[f"disconnected V={V} B=3"] = (
            lambda V=V: disconnected_graph(V, seed=V, batch=3))
    cases["count-clip V=312"] = lambda: count_clip_graph()[None]
    for name in LARGE_ARCHS:
        for cfg in ("baseline", "placeit"):
            cases[f"{name} {cfg} B=2"] = (
                lambda name=name, cfg=cfg: score_graphs(name, cfg, 2))
    return cases


def minplus_operands(M: int, K: int, N: int, seed: int = 0,
                     scale: float = 10.0, offset: float = 0.0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """A [M, K] and B [K, N] float32 with entries offset + scale * U[0, 1)."""
    rng = np.random.default_rng(seed)
    A = (offset + scale * rng.random((M, K))).astype(np.float32)
    B = (offset + scale * rng.random((K, N))).astype(np.float32)
    return A, B


# Entries the special-value min-plus cases plant (``minplus_special``).
MINPLUS_SPECIALS = ("nan in A", "nan in B", "+inf", "-inf and +inf",
                    "negative")


def minplus_special(M: int, K: int, N: int, kind: str, seed: int = 0
                    ) -> tuple[np.ndarray, np.ndarray]:
    """``minplus_operands`` with special entries planted (``kind`` one of
    ``MINPLUS_SPECIALS``): a NaN in a few rows of A or columns of B (their
    rows or columns of out are NaN); +inf on a quarter of both operands
    and on two whole rows of A (sums that hit the 1e9 ceiling); -inf
    beside +inf (-inf + inf is NaN, -inf + x is -inf); or entries in
    [-5, 5)."""
    rng = np.random.default_rng(seed)
    if kind == "negative":
        return minplus_operands(M, K, N, seed=seed, offset=-5.0)
    A, B = minplus_operands(M, K, N, seed=seed)
    if kind == "nan in A":
        A[rng.integers(M, size=3), rng.integers(K, size=3)] = np.nan
    elif kind == "nan in B":
        B[rng.integers(K, size=3), rng.integers(N, size=3)] = np.nan
    elif kind in ("+inf", "-inf and +inf"):
        A[rng.random((M, K)) < 0.25] = np.inf
        B[rng.random((K, N)) < 0.25] = np.inf
        A[rng.integers(M, size=2)] = np.inf     # rows at the ceiling
        if kind == "-inf and +inf":
            A[rng.integers(M, size=2), rng.integers(K, size=2)] = -np.inf
            B[rng.integers(K, size=2), rng.integers(N, size=2)] = -np.inf
    else:
        raise ValueError(f"no special kind {kind!r}")
    return A, B


def minplus_cases() -> dict:
    """Named factories of (A, B) for the min-plus product: the shapes of
    ``tests/test_kernels.py::test_minplus_tiled``; ragged M, N and K at the
    edges of the kernel's 96 x 96 tiles and 32-deep K-steps (and of 64 x
    64 tiles with 64-deep steps): each tile dimension -1, +1 and 2 tiles +
    1, K = 1, K not a multiple of the K-step, K and N multiples of 4 (the
    16-byte copies) or not (the guarded ones), M = 1 or N = 1 with
    K = 1536, and whole tiles over several K-steps (the steady-state
    loop); one
    case where every sum exceeds 1e9 (so every entry is the 1e9 ceiling);
    and NaN, +-inf and negative operands (``minplus_special``)."""
    cases = {}
    for M, K, N in ((64, 64, 64), (100, 70, 130), (128, 128, 128),
                    (1, 1, 1), (65, 17, 63), (130, 33, 129),
                    (95, 16, 97), (97, 17, 95), (193, 48, 193),
                    (63, 32, 65), (65, 31, 63), (129, 64, 129),
                    (96, 1, 96), (64, 1, 64), (96, 47, 96), (64, 33, 64),
                    (96, 33, 96), (64, 65, 64), (1, 1536, 200),
                    (200, 1536, 1), (192, 160, 288), (192, 170, 192),
                    (200, 166, 202), (131, 197, 129), (256, 256, 256)):
        cases[f"M={M} K={K} N={N}"] = (
            lambda M=M, K=K, N=N: minplus_operands(M, K, N, seed=M + K + N))
    cases["all sums > 1e9, M=40 K=24 N=72"] = (
        lambda: minplus_operands(40, 24, 72, seed=1, scale=1e8,
                                 offset=6e8))
    for kind in MINPLUS_SPECIALS:
        for M, K, N in ((70, 40, 90), (192, 64, 192)):
            cases[f"{kind}, M={M} K={K} N={N}"] = (
                lambda M=M, K=K, N=N, kind=kind: minplus_special(
                    M, K, N, kind, seed=M + K))
    return cases


def nan_equal(a, b) -> bool:
    """Bit for bit, NaN-aware: the same shape, NaN in the same places and
    equal values (``torch.equal``) everywhere else."""
    import torch
    if a.shape != b.shape:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, torch.zeros_like(a), a),
        torch.where(nb, torch.zeros_like(b), b)))


def attention_operands(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, d: int,
                       seed: int = 0) -> tuple:
    """q [B, Sq, Hq, d], k and v [B, Sk, Hkv, d]: float32 standard
    normals (cast to bfloat16 by the caller where wanted)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s, dtype=np.float32)
                 for s in ((B, Sq, Hq, d), (B, Sk, Hkv, d), (B, Sk, Hkv, d)))


def attention_cases() -> dict:
    """Named factories of (q, k, v, kwargs) for flash attention: the six
    cases of ``tests/test_kernels.py::ATTN_CASES`` (causal, GQA,
    bidirectional, a query chunk with Sq < Sk, a window, a soft-cap), then
    the head dims 64, 128 (qwen3's grouping) and 256 with ragged tiles, an
    explicit query offset, more queries than keys (rows that see nothing),
    and a bidirectional window."""
    specs = [
        (dict(B=1, Sq=16, Sk=16, Hq=4, Hkv=4, d=16), dict(causal=True)),
        (dict(B=2, Sq=24, Sk=24, Hq=4, Hkv=2, d=32), dict(causal=True)),
        (dict(B=2, Sq=24, Sk=24, Hq=6, Hkv=2, d=16), dict(causal=False)),
        (dict(B=1, Sq=8, Sk=32, Hq=4, Hkv=1, d=16), dict(causal=True)),
        (dict(B=1, Sq=32, Sk=32, Hq=2, Hkv=2, d=16),
         dict(causal=True, window=7)),
        (dict(B=1, Sq=16, Sk=16, Hq=4, Hkv=4, d=16),
         dict(causal=True, softcap=8.0)),
        (dict(B=1, Sq=80, Sk=80, Hq=8, Hkv=2, d=64), dict(causal=True)),
        (dict(B=2, Sq=130, Sk=130, Hq=4, Hkv=2, d=128), dict(causal=True)),
        (dict(B=1, Sq=70, Sk=70, Hq=2, Hkv=1, d=256),
         dict(causal=True, window=33, softcap=30.0)),
        (dict(B=1, Sq=16, Sk=100, Hq=4, Hkv=2, d=32),
         dict(causal=True, pos_offset=40)),
        (dict(B=1, Sq=40, Sk=24, Hq=2, Hkv=1, d=32), dict(causal=True)),
        (dict(B=1, Sq=33, Sk=33, Hq=2, Hkv=2, d=16),
         dict(causal=False, window=5)),
    ]
    cases = {}
    for i, (shape, kw) in enumerate(specs):
        name = " ".join(f"{k}={v}" for k, v in {**shape, **kw}.items())
        cases[name] = (lambda shape=shape, kw=kw, i=i:
                       (*attention_operands(**shape, seed=i), dict(kw)))
    return cases


def attention_tile_cases() -> dict:
    """Named factories of (q, k, v, kwargs) at the edges of the bfloat16
    flash kernel's tiles (64 query rows a block, 16 a warp; 32 keys a
    tile): Sq and Sk in {1, 63, 65, 127, 129, 300, 1000}, query chunks of
    a long prompt at several offsets (``pos_offset``), windows whose edges
    fall on and next to tile boundaries, soft-caps, bidirectional calls,
    more queries than keys, query heads per KV head g in {1, 2, 8, 16} and
    head dims 16 to 256.  Then the edges of the bfloat16 backward's tiles
    (``csrc/flash_attention_bwd.cu``: dk/dv 64 keys a block, 32 at
    d = 256, query tiles of 64 rows, 32 at d >= 128; dq 64 query rows a
    block, key tiles of 64, 32 at d >= 128): Sq and Sk one below and one
    above multiples of 32 and 64 (31, 33, 95, 97, 191, 193), windows of
    32 and 64 keys, and g = 3 (smollm-360m's 15 query heads on 5).  Then
    the MoE and encoder-decoder families' shapes: g = 6 at d = 128 with a
    soft-cap of 30 (grok-1's 48 query heads on 8), causal with Sq = Sk and
    a query chunk with Sq < Sk, and seamless's 16 heads of 64 attending a
    shorter memory bidirectionally (Sq > Sk, cross-attention)."""
    specs = [
        (dict(B=1, Sq=1, Sk=1, Hq=2, Hkv=1, d=128), dict(causal=True)),
        (dict(B=1, Sq=63, Sk=63, Hq=2, Hkv=2, d=64), dict(causal=True)),
        (dict(B=1, Sq=65, Sk=65, Hq=4, Hkv=2, d=128), dict(causal=True)),
        (dict(B=1, Sq=127, Sk=127, Hq=8, Hkv=1, d=32), dict(causal=True)),
        (dict(B=1, Sq=129, Sk=129, Hq=16, Hkv=1, d=256), dict(causal=True)),
        (dict(B=2, Sq=300, Sk=300, Hq=4, Hkv=2, d=128), dict(causal=True)),
        (dict(B=1, Sq=1000, Sk=1000, Hq=4, Hkv=2, d=128), dict(causal=True)),
        (dict(B=1, Sq=1000, Sk=1000, Hq=16, Hkv=1, d=256),
         dict(causal=True, window=256)),
        (dict(B=1, Sq=300, Sk=300, Hq=16, Hkv=1, d=256),
         dict(causal=True, window=64)),
        (dict(B=1, Sq=300, Sk=300, Hq=2, Hkv=1, d=128),
         dict(causal=True, window=65)),
        (dict(B=1, Sq=129, Sk=129, Hq=2, Hkv=2, d=64),
         dict(causal=True, window=63, softcap=30.0)),
        (dict(B=1, Sq=300, Sk=300, Hq=4, Hkv=2, d=128),
         dict(causal=True, softcap=50.0)),
        (dict(B=1, Sq=127, Sk=300, Hq=8, Hkv=1, d=64), dict(causal=False)),
        (dict(B=1, Sq=129, Sk=129, Hq=2, Hkv=1, d=32),
         dict(causal=False, window=64)),
        (dict(B=1, Sq=65, Sk=1000, Hq=4, Hkv=2, d=128),
         dict(causal=True, pos_offset=0)),
        (dict(B=1, Sq=65, Sk=1000, Hq=4, Hkv=2, d=128),
         dict(causal=True, pos_offset=64)),
        (dict(B=1, Sq=65, Sk=1000, Hq=4, Hkv=2, d=128),
         dict(causal=True, pos_offset=935)),
        (dict(B=1, Sq=1, Sk=1000, Hq=16, Hkv=1, d=256), dict(causal=True)),
        (dict(B=1, Sq=1000, Sk=63, Hq=1, Hkv=1, d=16), dict(causal=True)),
        (dict(B=1, Sq=63, Sk=127, Hq=2, Hkv=1, d=16), dict(causal=True)),
        (dict(B=2, Sq=191, Sk=191, Hq=15, Hkv=5, d=64), dict(causal=True)),
        (dict(B=1, Sq=97, Sk=97, Hq=6, Hkv=2, d=64), dict(causal=True)),
        (dict(B=1, Sq=95, Sk=95, Hq=3, Hkv=1, d=128), dict(causal=True)),
        (dict(B=1, Sq=193, Sk=193, Hq=8, Hkv=1, d=128),
         dict(causal=True, window=32)),
        (dict(B=1, Sq=193, Sk=193, Hq=3, Hkv=1, d=64),
         dict(causal=True, window=64, softcap=30.0)),
        (dict(B=1, Sq=33, Sk=97, Hq=3, Hkv=1, d=256), dict(causal=True)),
        (dict(B=1, Sq=31, Sk=33, Hq=2, Hkv=2, d=256), dict(causal=False)),
        (dict(B=1, Sq=97, Sk=31, Hq=3, Hkv=1, d=32), dict(causal=False)),
        (dict(B=1, Sq=193, Sk=193, Hq=12, Hkv=2, d=128),
         dict(causal=True, softcap=30.0)),
        (dict(B=1, Sq=65, Sk=300, Hq=6, Hkv=1, d=128),
         dict(causal=True, softcap=30.0)),
        (dict(B=1, Sq=300, Sk=129, Hq=16, Hkv=16, d=64), dict(causal=False)),
    ]
    cases = {}
    for i, (shape, kw) in enumerate(specs):
        name = " ".join(f"{k}={v}" for k, v in {**shape, **kw}.items())
        cases[name] = (lambda shape=shape, kw=kw, i=i:
                       (*attention_operands(**shape, seed=300 + i),
                        dict(kw)))
    return cases


def decode_operands(B: int, S: int, Hq: int, Hkv: int, d: int,
                    lengths, seed: int = 0) -> tuple:
    """q [B, Hq, d], caches [B, S, Hkv, d] (float32 standard normals) and
    lengths [B] int32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, d), dtype=np.float32)
    kc = rng.standard_normal((B, S, Hkv, d), dtype=np.float32)
    vc = rng.standard_normal((B, S, Hkv, d), dtype=np.float32)
    return q, kc, vc, np.asarray(lengths, np.int32)


def decode_cases() -> dict:
    """Named factories of (q, k_cache, v_cache, lengths, kwargs) for
    flash-decode: the three cases of
    ``tests/test_kernels.py::test_decode_attention`` (B = 3, lengths
    S, S // 2 and 1), ragged lengths with 0 and 1, a window, a soft-cap at
    qwen3's grouping and head dim, head dim 256 with 8 query rows per KV
    head, 16 query rows per KV head (two row chunks in the kernel), and
    grok-1's grouping (6 query rows per KV head of 128, soft-cap 30)."""
    specs = [
        (dict(S=33, Hq=4, Hkv=2, d=16), None, {}),
        (dict(S=64, Hq=8, Hkv=8, d=32), None, {}),
        (dict(S=40, Hq=4, Hkv=1, d=16), None, dict(window=9)),
        (dict(S=40, Hq=8, Hkv=2, d=32), [0, 1, 17, 40], {}),
        (dict(S=64, Hq=4, Hkv=2, d=64), [64, 5, 30], dict(window=9)),
        (dict(S=50, Hq=16, Hkv=8, d=128), [50, 1, 37], dict(softcap=5.0)),
        (dict(S=70, Hq=8, Hkv=1, d=256), [70, 21, 0],
         dict(window=20, softcap=30.0)),
        (dict(S=45, Hq=16, Hkv=1, d=16), [45, 44, 3], {}),
        (dict(S=50, Hq=6, Hkv=1, d=128), [50, 1, 37], dict(softcap=30.0)),
    ]
    cases = {}
    for i, (shape, lens, kw) in enumerate(specs):
        S = shape["S"]
        lens = [S, S // 2, 1] if lens is None else lens
        name = " ".join(f"{k}={v}" for k, v in {**shape, **kw}.items())
        name += f" lengths={lens}"
        cases[name] = (lambda shape=shape, lens=lens, kw=kw, i=i:
                       (*decode_operands(len(lens), **shape, lengths=lens,
                                         seed=100 + i), dict(kw)))
    return cases


def decode_split_cases() -> dict:
    """Named factories of (q, k_cache, v_cache, lengths, kwargs) at the
    edges of the decode kernel's split over S
    (``kernels.decode_attention.decode_splits``: here 2 to 64 chunks of
    256 to 512 positions, walked in 16-position tiles): lengths 0, 1, a
    chunk boundary and one either side of it, S, rows of different lengths
    in one call, a window, a soft-cap, the recurrentgemma ring (lengths
    clamped to S, no window), one split only (no partials), the most
    splits (64), query heads per KV head g in {1, 2, 8, 16} and 24 (two
    row chunks of the tensor-core kernel), head dims 16 to 256; grok-1's
    serve cache (48 query heads on 8 of 128, soft-cap 30, 4096 positions)
    and seamless's cross cache (16 heads of 64 over a 1024-frame memory)."""
    specs = [
        (dict(S=1024, Hq=2, Hkv=2, d=64), [0, 1, 255, 256, 257, 1024], {}),
        (dict(S=2000, Hq=4, Hkv=2, d=128), [2000, 1999, 513, 511, 512, 1],
         {}),
        (dict(S=1024, Hq=8, Hkv=1, d=32), [1024, 700, 256, 257, 10],
         dict(window=300)),
        (dict(S=1280, Hq=16, Hkv=1, d=256),
         [1280, 1279, 641, 640, 639, 321, 1], {}),
        (dict(S=1024, Hq=16, Hkv=1, d=256), [1024, 600, 0],
         dict(window=300, softcap=30.0)),
        (dict(S=600, Hq=2, Hkv=1, d=16), [600, 321, 320, 319, 2], {}),
        (dict(S=4096, Hq=16, Hkv=8, d=128), [4096, 257], {}),
        (dict(S=1024, Hq=24, Hkv=1, d=64), [1024, 257], {}),
        (dict(S=64, Hq=16, Hkv=1, d=128), [64, 0, 33], {}),
        (dict(S=16384, Hq=2, Hkv=1, d=64), [16384], {}),
        (dict(S=4096, Hq=48, Hkv=8, d=128), [4096, 2049, 1],
         dict(softcap=30.0)),
        (dict(S=1024, Hq=16, Hkv=16, d=64), [1024, 1024, 513], {}),
    ]
    cases = {}
    for i, (shape, lens, kw) in enumerate(specs):
        name = " ".join(f"{k}={v}" for k, v in {**shape, **kw}.items())
        name += f" lengths={lens}"
        cases[name] = (lambda shape=shape, lens=lens, kw=kw, i=i:
                       (*decode_operands(len(lens), **shape, lengths=lens,
                                         seed=400 + i), dict(kw)))
    return cases


def decode_pieces(fn, q, k_cache, v_cache, lengths, n: int, **kw):
    """Decode attention on a cache cut into ``n`` pieces over its
    positions (``ceil(S / n)`` each), as ranks holding a position-split
    cache run it: ``fn`` (a decode wrapper) on each piece with its local
    lengths ``clamp(lengths - lo, 0)`` (and at most the piece's length
    without a window; the window stays against the global position) and
    ``return_lse``, then ``ref.merge_decode_ref``.  Rows whose whole
    length lies in one piece see no position in the others."""
    S = k_cache.shape[1]
    step = -(-S // n)
    outs, lses = [], []
    for lo in range(0, S, step):
        hi = min(lo + step, S)
        local = (lengths - lo).clamp(min=0)
        if kw.get("window") is None:
            local = local.clamp(max=hi - lo)
        o, lse = fn(q, k_cache[:, lo:hi].contiguous(),
                    v_cache[:, lo:hi].contiguous(),
                    local.to(lengths.dtype), return_lse=True, **kw)
        outs.append(o)
        lses.append(lse)
    return ref.merge_decode_ref(outs, lses)


def sscan_operands(Bt: int, S: int, Di: int, N: int, seed: int = 0,
                   h0: bool = False) -> tuple:
    """x, dt, A, B, C, D (and h0 [Bt, Di, N], else None) for the selective
    scan, float32, drawn as ``tests/test_kernels.py::test_selective_scan``
    draws them: x, B, C, D standard normal, dt in 0.1 + [0, 1), A in
    -[0, 1)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((Bt, S, Di), dtype=f)
    dt = (0.1 + rng.random((Bt, S, Di))).astype(f)
    A = (-rng.random((Di, N))).astype(f)
    B = rng.standard_normal((Bt, S, N), dtype=f)
    C = rng.standard_normal((Bt, S, N), dtype=f)
    D = rng.standard_normal(Di, dtype=f)
    hs = rng.standard_normal((Bt, Di, N), dtype=f) if h0 else None
    return x, dt, A, B, C, D, hs


def rglru_operands(B: int, S: int, D: int, seed: int = 0,
                   h0: bool = False) -> tuple:
    """x, a (and h0 [B, D], else None) for the RG-LRU scan, float32, drawn
    as ``tests/test_kernels.py::test_rglru_scan`` draws them: x standard
    normal, a in 0.05 + 0.9 [0, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    a = (0.05 + 0.9 * rng.random((B, S, D))).astype(np.float32)
    hs = rng.standard_normal((B, D), dtype=np.float32) if h0 else None
    return x, a, hs


def scan_cases() -> dict:
    """Named factories of operands for the two scan kernels, keyed
    ``"selective_scan ..."`` (``sscan_operands``) and ``"rglru ..."``
    (``rglru_operands``): the three shapes of each kernel's test in
    ``tests/test_kernels.py`` (Di = 130 and D = 130 ragged), then a single
    step (S = 1), several batch rows, sequences that end inside a 32-step
    chunk with channels that end inside a 32-channel block, state sizes 5
    and 16, and a starting state h0; last, a selective scan ragged against
    the backward kernel's 64-channel blocks that spans 18 of them, its
    sequence ending inside a 32-step chunk."""
    specs = [
        ("selective_scan", dict(Bt=1, S=8, Di=16, N=4)),
        ("selective_scan", dict(Bt=2, S=12, Di=20, N=8)),
        ("selective_scan", dict(Bt=2, S=7, Di=130, N=4)),
        ("selective_scan", dict(Bt=3, S=1, Di=64, N=16)),
        ("selective_scan", dict(Bt=2, S=77, Di=45, N=5, h0=True)),
        ("selective_scan", dict(Bt=1, S=130, Di=300, N=16, h0=True)),
        ("rglru", dict(B=1, S=8, D=16)),
        ("rglru", dict(B=2, S=20, D=40)),
        ("rglru", dict(B=2, S=5, D=130)),
        ("rglru", dict(B=3, S=1, D=64)),
        ("rglru", dict(B=2, S=77, D=45, h0=True)),
        ("rglru", dict(B=1, S=130, D=300, h0=True)),
        ("selective_scan", dict(Bt=2, S=100, Di=1100, N=16, h0=True)),
    ]
    cases = {}
    for i, (kernel, kw) in enumerate(specs):
        make = sscan_operands if kernel == "selective_scan" else rglru_operands
        name = kernel + " " + " ".join(f"{k}={v}" for k, v in kw.items())
        cases[name] = (lambda make=make, kw=kw, i=i:
                       make(**kw, seed=200 + i))
    return cases


class PlainAttention(torch.autograd.Function):
    """Flash attention's plain versions with their gradient, on any
    device: ``ref.attention_ref`` (with its log-sum-exp) forward and
    ``ref.attention_bwd_ref`` backward.  Not on any path of the port: a
    check substitutes it for ``ops.flash_attention`` to hold a training
    step through the kernels against the same step through the plain
    versions on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, softcap, pos_offset):
        kw = dict(causal=causal, window=window, scale=scale, softcap=softcap,
                  pos_offset=pos_offset)
        out, lse = ref.attention_ref(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = ref.attention_bwd_ref(q, k, v, out, dout, lse, **ctx.kw)
        return (*grads, None, None, None, None, None)


def plain_attention(q, k, v, *, causal=True, window=None, scale=None,
                    softcap=None, pos_offset=None):
    """``ops.flash_attention``'s signature over :class:`PlainAttention`."""
    return PlainAttention.apply(q, k, v, causal, window, scale, softcap,
                                pos_offset)


def rglru_edge_operands(seed: int = 3, above: float = 2.0 ** -8) -> tuple:
    """RG-LRU operands where its gradient is not finite, as numpy float32
    (x, a, h0, dy, dh_final): B = 2, S = 12, D = 16, a from {0, 0.5, 1,
    1 + ``above``}, x 0 in a third of the places, and channel 0 of each
    row with no gradient at all (dy = dh_final = 0 there, so G = 0).  In
    bfloat16, 1 + 2^-8 rounds to 1: ``above`` 2^-7 keeps an a above 1."""
    rng = np.random.default_rng(seed)
    shape = (2, 12, 16)
    a = rng.choice(np.array([0.0, 0.5, 1.0, 1.0 + above], np.float32),
                   shape)
    x = rng.standard_normal(shape, dtype=np.float32)
    x[rng.random(shape) < 1 / 3] = 0.0
    h0 = rng.standard_normal((2, 16), dtype=np.float32)
    dy = rng.standard_normal(shape, dtype=np.float32)
    dhf = rng.standard_normal((2, 16), dtype=np.float32)
    dy[:, :, 0] = 0.0
    dhf[:, 0] = 0.0
    return x, a, h0, dy, dhf


# The scans' backward kernels against their plain versions on the card:
# |kernel - plain| <= share max|plain| + rtol |plain|, each gradient.  On
# ``scan_cases`` (S <= 130) share 3e-5 and, for float32 gradients, rtol
# 3e-5 (ex2.approx against exp, fused multiply-adds, other orders over
# states, channels and steps); at the training shapes (S = 4096) 1e-4 and
# 1e-4, as G carries each step's rounding over thousands of steps.  A
# gradient in bfloat16 (dx, RG-LRU's da) gets rtol 2^-7: both round a
# float32 value once, and two close values may round an ulp apart.
SCAN_BWD_LIMITS = {"cases": (3e-5, 3e-5), "training": (1e-4, 1e-4)}
SCAN_BWD_BF16_RTOL = 2.0 ** -7


def scan_bwd_limit(which: str, dtype) -> str:
    """``SCAN_BWD_LIMITS[which]`` for a gradient of ``dtype``, as text."""
    share, rtol = SCAN_BWD_LIMITS[which]
    if dtype == torch.bfloat16:
        rtol = SCAN_BWD_BF16_RTOL
    return f"|kernel - plain| <= {share:g} max|plain| + {rtol:g} |plain|"


def scan_bwd_share(got: torch.Tensor, want: torch.Tensor, which: str
                   ) -> tuple[float, float]:
    """(max abs error, the largest share of the limit an entry uses) of a
    scan gradient against its plain version, under ``SCAN_BWD_LIMITS``,
    over their finite entries; both of one dtype and shape, with NaN and
    +-inf in the same places (RG-LRU's da where a = 1), else inf."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise ValueError(f"{got.dtype} {tuple(got.shape)} against "
                         f"{want.dtype} {tuple(want.shape)}")
    share, rtol = SCAN_BWD_LIMITS[which]
    if got.dtype == torch.bfloat16:
        rtol = SCAN_BWD_BF16_RTOL
    a, b = got.float(), want.float()
    fin = torch.isfinite(b)
    if not (torch.equal(fin, torch.isfinite(a))
            and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a[b.isinf()], b[b.isinf()])):
        return math.inf, math.inf
    a, b = a[fin], b[fin]
    if not b.numel():
        return 0.0, 0.0
    err = (a - b).abs()
    limit = share * b.abs().max() + rtol * b.abs()
    used = torch.where(err == 0, 0.0, err / limit)
    return float(err.max()), float(used.max())


class PlainSelectiveScan(torch.autograd.Function):
    """The selective scan's plain versions with their gradient, on any
    device: ``ref.selective_scan_ref`` forward and
    ``ref.selective_scan_bwd_ref`` backward.  Not on any path of the port:
    a check substitutes it for ``ops.selective_scan`` to hold a training
    step through the kernels against the same step through the plain
    versions on the card."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, D, h0)
        return ref.selective_scan_ref(x, dt, A, B, C, D, h0)

    @staticmethod
    def backward(ctx, dy, dhf):
        x, dt, A, B, C, D, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ref.selective_scan_bwd_ref(x, dt, A, B, C, D, h0, dy, dhf)
        return (*grads[:6], None if h0 is None else grads[6])


def plain_selective_scan(x, dt, A, B, C, D, h0=None):
    """``ops.selective_scan``'s signature over :class:`PlainSelectiveScan`."""
    return PlainSelectiveScan.apply(x, dt, A, B, C, D, h0)


class PlainRGLRUScan(torch.autograd.Function):
    """The RG-LRU scan's plain versions with their gradient, on any device:
    ``ref.rglru_ref`` forward and ``ref.rglru_bwd_ref`` backward; on no
    path of the port (as :class:`PlainSelectiveScan`)."""

    @staticmethod
    def forward(ctx, x, a, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, a, h0)
        return ref.rglru_ref(x, a, h0)

    @staticmethod
    def backward(ctx, dy, dhf):
        x, a, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, da, dh0 = ref.rglru_bwd_ref(x, a, h0, dy, dhf)
        return dx, da, None if h0 is None else dh0


def plain_rglru_scan(x, a, h0=None):
    """``ops.rglru_scan``'s signature over :class:`PlainRGLRUScan`."""
    return PlainRGLRUScan.apply(x, a, h0)


def attention_bwd_rounded(q, k, v, o, dout, lse, *, causal=True,
                          window=None, scale=None, softcap=None,
                          pos_offset=None) -> tuple:
    """A plain model of the bfloat16 backward kernel's rounding
    (``csrc/flash_attention_bwd.cu``): ``ref.attention_bwd_ref``'s
    arithmetic, float32 sums, with P rounded to bfloat16 before dv = P^T
    dO and dS rounded to bfloat16 before dk = scale dS^T q and dq = scale
    dS k, as the kernel feeds them to the tensor cores.  Test helper, on
    no path of the port."""
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = d ** -0.5 if scale is None else scale
    pos_offset = Sk - Sq if pos_offset is None else pos_offset
    qh = q.reshape(B, Sq, Hkv, g, d).float()
    gh = dout.reshape(B, Sq, Hkv, g, d).float()
    kf, vf = k.float(), v.float()
    z = torch.einsum("bqhgd,bkhd->bhgqk", qh, kf) * scale
    if softcap is not None:
        t = torch.tanh(z / softcap)
        z = softcap * t
    lse_h = lse.reshape(B, Hkv, g, Sq, 1)
    mask = ref._attention_mask(Sq, Sk, causal, window, pos_offset, q.device)
    p = torch.where(mask & torch.isfinite(lse_h), torch.exp(z - lse_h), 0.0)
    dsum = (dout.float() * o.float()).sum(-1)
    dsum = dsum.reshape(B, Sq, Hkv, g).permute(0, 2, 3, 1)[..., None]
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", gh, vf) - dsum)
    if softcap is not None:
        ds = ds * (1.0 - t * t)
    p, ds = (x.to(torch.bfloat16).float() for x in (p, ds))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, gh)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qh) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    return (dq.reshape(B, Sq, Hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
