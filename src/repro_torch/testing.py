"""Seeded numpy inputs for holding the FW kernel against its plain version.

Shared by the tests (``tests/test_torch_*.py``) and ``chip_smoke.py``, so
both check the kernel on the same graphs: random sparse graphs shaped like
``tests/test_kernels.py::random_graph``, graphs that are not connected, the
count-clip layered graph of ``tests/test_properties.py``, and real score
graphs of the paper's homogeneous archs.
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


def score_graphs(arch_name: str, config: str, n: int,
                 seed: int = 5) -> np.ndarray:
    """[n, V, V] real score-graph weights of random placements of a paper
    homogeneous arch (``HomogRep.random`` from a numpy seed)."""
    from .core.api import make_rep
    from .core.chiplets import paper_arch
    arch = paper_arch(arch_name, config)
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
