"""Seeded numpy inputs for holding the kernels against their plain versions.

Shared by the tests (``tests/test_torch_*.py``) and ``chip_smoke.py``, so
both check the kernels on the same inputs: random sparse graphs shaped like
``tests/test_kernels.py::random_graph``, graphs that are not connected, the
count-clip layered graph of ``tests/test_properties.py``, real score graphs
of the homogeneous archs (the paper's and the 100+-chiplet families), and
min-plus operands with ragged shapes.
"""
from __future__ import annotations

import numpy as np

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


def minplus_cases() -> dict:
    """Named factories of (A, B) for the min-plus product: the shapes of
    ``tests/test_kernels.py::test_minplus_tiled``, ragged M, N and K
    around the kernel's 64 x 64 x 16 tiles, and one case where every sum
    exceeds 1e9 (so every entry is the 1e9 ceiling)."""
    cases = {}
    for M, K, N in ((64, 64, 64), (100, 70, 130), (128, 128, 128),
                    (1, 1, 1), (65, 17, 63), (130, 33, 129)):
        cases[f"M={M} K={K} N={N}"] = (
            lambda M=M, K=K, N=N: minplus_operands(M, K, N, seed=M + K + N))
    cases["all sums > 1e9, M=40 K=24 N=72"] = (
        lambda: minplus_operands(40, 24, 72, seed=1, scale=1e8,
                                 offset=6e8))
    return cases
