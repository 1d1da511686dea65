"""Placement-based ICI topology inference (paper §V-A get_network, §VI-A).

The common output of both placement representations is a ``ScoreGraph``: a
PHY-level latency graph augmented with virtual per-chiplet source/sink nodes,
plus the directed D2D edge list used for throughput (link-load) estimation.

Node layout (V = Vp + 2*N):
    [0, Vp)          PHY nodes
    [Vp, Vp+N)       virtual *source* nodes, one per chiplet (out-edges only)
    [Vp+N, Vp+2N)    virtual *sink* nodes, one per chiplet (in-edges only)

Edge weights [cycles]:
    src_c -> p (p in PHYs(c)) : 0     (injection picks any own PHY)
    p -> dst_c (p in PHYs(c)) : 0     (ejection from any own PHY)
    D2D link  p <-> q         : 2*L_P + L_L   (PHY out + link + PHY in)
    internal  p <-> q same chiplet, relay-capable : L_R

Because virtual sources have no in-edges and sinks no out-edges, no path can
"tunnel" through a chiplet via its virtual nodes; through-traffic is possible
only across internal edges, which exist exactly for relay-capable chiplets —
this encodes the paper's relay semantics without per-node surcharges.

This is the host half of ``repro.core.topology`` (numpy only); the batched
graph builders come with the device pipeline (ROADMAP queue 1 items 7-8).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .chiplets import ArchSpec

INF = np.float32(1.0e9)

# Canonical grid-direction conventions of the homogeneous representation:
# facing direction of a single-PHY chiplet after rotation r, the opposite
# direction, and the (row, col) delta per direction (row grows northwards).
# placement_homog imports these (this module cannot import it back).
ROT_DIR = ("s", "e", "n", "w")
OPP_DIR = {"n": "s", "s": "n", "e": "w", "w": "e"}
DIR_DELTA = {"n": (1, 0), "s": (-1, 0), "e": (0, 1), "w": (0, -1)}


@dataclass
class PlacedPhys:
    """Geometry of one concrete placement, host-side."""

    pos: np.ndarray       # [Vp, 2] float32, PHY positions in mm
    owner: np.ndarray     # [Vp] int32, owning chiplet instance
    relay: np.ndarray     # [N] bool, per chiplet instance
    kinds: np.ndarray     # [N] int8, chiplet kind per instance
    area: float           # enclosing-rectangle area in mm^2


@dataclass
class ScoreGraph:
    """Fixed-shape scoring input for one placement (stackable into batches)."""

    W: np.ndarray          # [V, V] float32 latency weights (diag 0, INF else)
    edges: np.ndarray      # [E_max, 2] int32 directed D2D edges (padded)
    edge_mask: np.ndarray  # [E_max] bool
    area: np.float32
    connected: bool
    edge_len: np.ndarray | None = None   # [E_max] float32 link lengths [mm]

    @property
    def V(self) -> int:
        return self.W.shape[0]


class _UnionFind:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, a: int) -> int:
        while self.p[a] != a:
            self.p[a] = self.p[self.p[a]]
            a = self.p[a]
        return a

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.p[ra] = rb
        return True


def infer_links_mst(arch: ArchSpec, geo: PlacedPhys,
                    strict_phy_use: bool = False
                    ) -> tuple[list[tuple[int, int]], bool]:
    """§VI-A topology inference: MST over the PHY graph + augmentation.

    Returns (links, connected).  ``links`` are undirected PHY index pairs.

    * Internal edges (weight 0 for MST purposes) join all PHYs of a
      relay-capable chiplet.
    * Candidate edges join PHYs of different chiplets at distance <=
      max_link_mm; their MST weight is the link length.
    * D2D links = candidate edges picked by the MST, then remaining candidate
      edges in increasing-weight order whenever both endpoint PHYs are still
      unused by a D2D link.
    * ``strict_phy_use=True`` additionally forbids the MST itself from
      assigning two links to one PHY (beyond-paper physical constraint; the
      paper's formulation is the default).
    """
    Vp = geo.pos.shape[0]
    uf = _UnionFind(Vp)
    # Internal (free) unions inside relay chiplets.
    for c in np.unique(geo.owner):
        idx = np.nonzero(geo.owner == c)[0]
        if geo.relay[c]:
            for k in range(1, len(idx)):
                uf.union(int(idx[0]), int(idx[k]))
    # Candidate edges (vectorized pairwise distances).
    diff = geo.pos[:, None, :] - geo.pos[None, :, :]
    if arch.distance == "manhattan":
        dist = np.abs(diff).sum(-1)
    else:
        dist = np.sqrt((diff ** 2).sum(-1))
    same_owner = geo.owner[:, None] == geo.owner[None, :]
    upper = np.triu(np.ones((Vp, Vp), dtype=bool), k=1)
    ok = upper & ~same_owner & (dist <= arch.max_link_mm + 1e-9)
    pp, qq = np.nonzero(ok)
    order = np.argsort(dist[pp, qq], kind="stable")
    cands: list[tuple[float, int, int]] = [
        (float(dist[pp[i], qq[i]]), int(pp[i]), int(qq[i])) for i in order]
    phy_used = np.zeros(Vp, dtype=bool)
    links: list[tuple[int, int]] = []
    # Kruskal over candidate edges (internal edges already merged, weight 0).
    for d, p, q in cands:
        if strict_phy_use and (phy_used[p] or phy_used[q]):
            continue
        if uf.union(p, q):
            links.append((p, q))
            phy_used[p] = phy_used[q] = True
    # Connectivity: some single component must contain at least one PHY of
    # every chiplet.  (A chiplet with several PHYs and no relay has its PHYs
    # in separate UF nodes; any one of them inside the common component
    # suffices.  Checking only the component with the most PHYs is wrong: a
    # smaller component can be the one touching every chiplet.)
    comp_of_phy = np.array([uf.find(p) for p in range(Vp)])
    owners = np.unique(geo.owner)
    connected = False
    for root in np.unique(comp_of_phy):
        members = comp_of_phy == root
        if all(members[geo.owner == c].any() for c in owners):
            connected = True
            break
    # Augmentation: add remaining candidates joining two unused PHYs.
    for d, p, q in cands:
        if not phy_used[p] and not phy_used[q] and (p, q) not in links:
            links.append((p, q))
            phy_used[p] = phy_used[q] = True
    return links, connected


def build_score_graph(arch: ArchSpec, geo: PlacedPhys,
                      links: list[tuple[int, int]], e_max: int,
                      connected: bool) -> ScoreGraph:
    """Assemble the fixed-shape ScoreGraph from geometry + chosen D2D links."""
    Vp = geo.pos.shape[0]
    N = geo.kinds.shape[0]
    V = Vp + 2 * N
    W = np.full((V, V), INF, dtype=np.float32)
    np.fill_diagonal(W, 0.0)
    d2d = np.float32(arch.latency.d2d_cost())
    lr = np.float32(arch.latency.l_relay)
    # Internal relay edges.
    for c in range(N):
        if not geo.relay[c]:
            continue
        idx = np.nonzero(geo.owner == c)[0]
        for a in range(len(idx)):
            for b in range(a + 1, len(idx)):
                p, q = int(idx[a]), int(idx[b])
                W[p, q] = min(W[p, q], lr)
                W[q, p] = min(W[q, p], lr)
    # D2D links.
    for p, q in links:
        W[p, q] = min(W[p, q], d2d)
        W[q, p] = min(W[q, p], d2d)
    # Virtual source/sink edges.
    for c in range(N):
        idx = np.nonzero(geo.owner == c)[0]
        W[Vp + c, idx] = 0.0          # src_c -> own PHYs
        W[idx, Vp + N + c] = 0.0      # own PHYs -> dst_c
    edges = np.zeros((e_max, 2), dtype=np.int32)
    mask = np.zeros((e_max,), dtype=bool)
    elen = np.zeros((e_max,), dtype=np.float32)
    n_e = 0
    for p, q in links:
        d = np.float32(arch.dist(tuple(geo.pos[p]), tuple(geo.pos[q])))
        for (u, v) in ((p, q), (q, p)):
            if n_e >= e_max:  # pragma: no cover - e_max sized generously
                raise ValueError("e_max too small")
            edges[n_e] = (u, v)
            mask[n_e] = True
            elen[n_e] = d
            n_e += 1
    return ScoreGraph(W=W, edges=edges, edge_mask=mask,
                      area=np.float32(geo.area), connected=connected,
                      edge_len=elen)


def stack_graphs(graphs: list[ScoreGraph]) -> dict:
    """Stack per-placement ScoreGraphs into batched numpy arrays for the
    scorer."""
    return dict(
        W=np.stack([g.W for g in graphs]),
        edges=np.stack([g.edges for g in graphs]),
        edge_mask=np.stack([g.edge_mask for g in graphs]),
        area=np.array([g.area for g in graphs], dtype=np.float32),
        edge_len=np.stack([np.zeros(g.edges.shape[0], np.float32)
                           if g.edge_len is None else g.edge_len
                           for g in graphs]),
    )
