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

The port of ``repro.core.topology``: the host build is numpy; the
batched builds (:class:`HomogGraphBatch`, :class:`HeteroGraphBatch`) are
tensor ops on a device and equal the host build bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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


def _static_W(arch: ArchSpec, owner: np.ndarray, Vp: int, n: int
              ) -> np.ndarray:
    """The placement-independent part of W: the diagonal, the internal
    relay edges and the virtual source/sink edges."""
    V = Vp + 2 * n
    W = np.full((V, V), INF, dtype=np.float32)
    np.fill_diagonal(W, 0.0)
    lr = np.float32(arch.latency.l_relay)
    for c in range(n):
        idx = np.nonzero(owner == c)[0]
        if arch.chiplets[c].relay:
            for a in range(len(idx)):
                for b2 in range(a + 1, len(idx)):
                    p, q = int(idx[a]), int(idx[b2])
                    W[p, q] = min(W[p, q], lr)
                    W[q, p] = min(W[q, p], lr)
        W[Vp + c, idx] = 0.0
        W[idx, Vp + n + c] = 0.0
    return W


def _phy_layout(arch: ArchSpec) -> tuple[np.ndarray, np.ndarray]:
    """(phy_base [N + 1], owner [Vp]) of the arch's chiplet instances."""
    n = len(arch.chiplets)
    phy_base = np.zeros(n + 1, dtype=np.int64)
    for i, ch in enumerate(arch.chiplets):
        phy_base[i + 1] = phy_base[i] + ch.n_phys()
    owner = np.zeros(int(phy_base[-1]), dtype=np.int64)
    for i in range(n):
        owner[phy_base[i]:phy_base[i + 1]] = i
    return phy_base, owner


def _scatter_links(W_static: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """[V, V] static weights + per-placement links u, v [B, L] with weights
    vals [B, L] -> [B, V, V], scatter-min both ways (a pad slot at (0, 0)
    with INF is a no-op, since W[0, 0] = 0)."""
    B, V = u.shape[0], W_static.shape[-1]
    W = W_static.reshape(1, V * V).repeat(B, 1)
    W.scatter_reduce_(1, u * V + v, vals, "amin")
    W.scatter_reduce_(1, v * V + u, vals, "amin")
    return W.view(B, V, V)


def _both_ways(u: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
               length: torch.Tensor) -> tuple:
    """Undirected link slots [B, L] -> directed (edges [B, 2L, 2] int32,
    edge_mask [B, 2L], edge_len [B, 2L]), (u, v) then (v, u) per slot as
    the host build writes them."""
    B = u.shape[0]
    edges = torch.stack([torch.stack([u, v], -1), torch.stack([v, u], -1)],
                        2).reshape(B, -1, 2).to(torch.int32)
    return (edges, mask.repeat_interleave(2, dim=1),
            length.repeat_interleave(2, dim=1))


# ---------------------------------------------------------------------------
# Batched ScoreGraph assembly for the homogeneous grid.
#
# §V-A get_network as tensor ops: the candidate-link structure of an R x C
# grid is *static* — each of the A = R(C-1) + (R-1)C cell adjacencies either
# carries a D2D link (both facing PHYs exist) or not — so link inference is
# masked selection over a fixed adjacency table instead of the heterogeneous
# path's MST + union-find.  Everything about the graph that does not depend
# on the placement (diagonal, internal relay edges, virtual source/sink
# edges) is built once into one static weight matrix on the device; a batch
# of placements only scatters its D2D links on top.  Connectivity is NOT
# decided here: the scorer derives it from the Floyd-Warshall distance
# matrix (a placement is connected iff no virtual src->sink distance reaches
# ``INF_CUT``), so invalid individuals are masked-and-resampled in batch by
# the optimizers instead of retried one at a time.  The links fill
# their slots in the host's order (adjacency order, then the padding), so
# the edge arrays equal the host's slot for slot.
# ---------------------------------------------------------------------------


class HomogGraphBatch:
    """Batched ``(types, rot) -> stacked ScoreGraph arrays`` for one grid,
    on ``device``."""

    def __init__(self, arch: ArchSpec, R: int, C: int,
                 area: float | None = None, device="cpu"):
        self.arch, self.R, self.C = arch, R, C
        self.device = dev = torch.device(device)
        n = len(arch.chiplets)
        phy_base, owner = _phy_layout(arch)
        Vp = int(phy_base[-1])
        self.Vp, self.N = Vp, n
        self.V = Vp + 2 * n
        self.e_max = 2 * (R * (C - 1) + (R - 1) * C)
        self._nphys = torch.tensor([ch.n_phys() for ch in arch.chiplets],
                                   device=dev)
        self._phy_base = torch.as_tensor(phy_base[:-1], device=dev)
        # Row-major instance assignment table: j-th chiplet of kind k.
        by_kind = {k: [i for i, ch in enumerate(arch.chiplets)
                       if ch.kind == k] for k in (0, 1, 2)}
        maxc = max(1, max(len(v) for v in by_kind.values()))
        table = np.zeros((3, maxc), np.int64)
        for k, ids in by_kind.items():
            table[k, :len(ids)] = ids
        self._kind_table = torch.as_tensor(table, device=dev)
        self._W_static = torch.as_tensor(_static_W(arch, owner, Vp, n),
                                         device=dev)
        self._d2d = float(np.float32(arch.latency.d2d_cost()))
        # Static adjacency table: cell pair + facing directions, scanning
        # each adjacency once ("n"/"e"), as in HomogRep.links_of.
        cell1, cell2, loc1, loc2, rot1, rot2 = [], [], [], [], [], []
        for r in range(R):
            for c in range(C):
                for d in ("n", "e"):
                    dr, dc = DIR_DELTA[d]
                    rr, cc = r + dr, c + dc
                    if not (0 <= rr < R and 0 <= cc < C):
                        continue
                    o = OPP_DIR[d]
                    cell1.append(r * C + c)
                    cell2.append(rr * C + cc)
                    loc1.append("nesw".index(d))    # 4-PHY local index
                    loc2.append("nesw".index(o))
                    rot1.append(ROT_DIR.index(d))  # 1-PHY rotation
                    rot2.append(ROT_DIR.index(o))
        self._a_cell1, self._a_cell2, self._a_loc1, self._a_loc2, \
            self._a_rot1, self._a_rot2 = (
                torch.tensor(x, dtype=torch.long, device=dev)
                for x in (cell1, cell2, loc1, loc2, rot1, rot2))
        # Static per-adjacency link lengths: distance between the facing
        # side midpoints of the two cells (HomogRep.geometry's PHY spots;
        # 0.0 for touching chiplets).  float32, matching the host
        # build_score_graph's edge_len.
        sz_mm = arch.chiplets[0].w
        mids = {"n": (sz_mm / 2, sz_mm), "s": (sz_mm / 2, 0.0),
                "e": (sz_mm, sz_mm / 2), "w": (0.0, sz_mm / 2)}

        def _side_pos(cell, side):
            r, c = divmod(int(cell), C)
            mx, my = mids[side]
            pa = np.array([c * sz_mm + mx, r * sz_mm + my], np.float32)
            return (float(pa[0]), float(pa[1]))

        alen = [np.float32(arch.dist(_side_pos(c1, "nesw"[l1]),
                                     _side_pos(c2, "nesw"[l2])))
                for c1, c2, l1, l2 in zip(cell1, cell2, loc1, loc2)]
        self._a_len = torch.as_tensor(np.array(alen, np.float32), device=dev)
        # §V-A get_area: identical for every placement on the grid.  A
        # masked rep (hex arrangement) passes its own cell count via
        # ``area`` — masked cells are not part of the package.
        sz = arch.chiplets[0].w * arch.chiplets[0].h
        self.area = float(np.float32(sz * R * C if area is None else area))

    def _instances(self, tflat: torch.Tensor) -> torch.Tensor:
        """Row-major instance ids per cell ([B, cells], -1 for empty)."""
        inst = torch.full(tflat.shape, -1, dtype=torch.long,
                          device=tflat.device)
        for k in range(3):
            mk = tflat == k
            rank = (mk.cumsum(1) - 1).clamp(0, self._kind_table.shape[1] - 1)
            inst = torch.where(mk, self._kind_table[k][rank], inst)
        return inst

    def _phy_at(self, inst, rot, loc4, rotidx):
        """Global PHY index facing the adjacency (or -1)."""
        ic = inst.clamp_min(0)
        base = self._phy_base[ic]
        return torch.where(self._nphys[ic] == 4, base + loc4,
                           torch.where(rot == rotidx, base, -1))

    def build(self, types: torch.Tensor, rot: torch.Tensor) -> dict:
        """[B, R, C] stacked placements on the device -> batched ScoreGraph
        arrays (the keys of :func:`stack_graphs`), tensors on the device,
        equal to the host build's slot for slot."""
        B = types.shape[0]
        tflat = types.reshape(B, -1).long()
        rflat = rot.reshape(B, -1).long()
        inst = self._instances(tflat)
        i1 = inst[:, self._a_cell1]
        i2 = inst[:, self._a_cell2]
        p = self._phy_at(i1, rflat[:, self._a_cell1], self._a_loc1,
                         self._a_rot1)
        q = self._phy_at(i2, rflat[:, self._a_cell2], self._a_loc2,
                         self._a_rot2)
        valid = (i1 >= 0) & (i2 >= 0) & (p >= 0) & (q >= 0)
        # The links first, in adjacency order, then the padding: the host
        # build's slots.
        take = (~valid).to(torch.int8).argsort(dim=1, stable=True)
        valid = valid.gather(1, take)
        pu = torch.where(valid, p.gather(1, take), 0)
        qu = torch.where(valid, q.gather(1, take), 0)
        vals = torch.where(valid, self._d2d, float(INF))
        elen = torch.where(valid, self._a_len[take], 0.0)
        edges, mask, edge_len = _both_ways(pu, qu, valid, elen)
        return dict(W=_scatter_links(self._W_static, pu, qu, vals),
                    edges=edges, edge_mask=mask, edge_len=edge_len,
                    area=torch.full((B,), self.area, dtype=torch.float32,
                                    device=types.device))


def build_score_graphs_batched(arch: ArchSpec, R: int, C: int,
                               types, rot) -> dict:
    """One-shot convenience wrapper around :class:`HomogGraphBatch` on the
    placements' device."""
    return HomogGraphBatch(arch, R, C, device=types.device).build(types, rot)


# ---------------------------------------------------------------------------
# Batched ScoreGraph assembly for heterogeneous placements.
#
# §VI-A link inference as fixed-shape tensor ops over the batch.  Unlike the
# grid, the candidate-link structure is data-dependent (pairwise PHY
# distances of a corner placement), so the host path runs Kruskal +
# union-find per individual.  Here the same result is computed for the
# whole batch at once:
#
# * a padded candidate-edge tensor over the *static* cross-chiplet PHY
#   pairs (row-major p < q order, exactly the host's np.nonzero
#   enumeration); per placement an edge is valid iff its length is within
#   max_link_mm;
# * per placement, candidates get distinct integer weights: their rank
#   under a stable sort by length (ties broken by enumeration order) —
#   precisely the order the host's stable Kruskal consumes.  With distinct
#   weights the MST is unique, so a batched Borůvka (log2 rounds of
#   per-component min-edge selection + pointer-jumping star contraction)
#   returns bit-for-bit the host's Kruskal edge set.  The host's weight-0
#   relay-internal edges are pre-merged into the initial component labels;
# * the paper's greedy augmentation (remaining candidates joining two
#   still-unused PHYs, in weight order) is a greedy matching.  Each round
#   takes every eligible edge that is the cheapest eligible edge at both of
#   its endpoints; with distinct weights these rounds give exactly the
#   sequential scan's matching (every such edge is one the scan accepts, and
#   the rounds stop only once no eligible edge is left).  The rounds run
#   until no row of the batch has an eligible edge, at most Vp // 2 of them;
# * ``connected`` is derived from the final component labels with the same
#   rule as the (fixed) host check: some single component must contain at
#   least one PHY of every chiplet.  It is returned in the batch dict so
#   the device pipeline can mask-and-resample without trusting the
#   scorer's FW-reachability flag (subtly laxer on multi-PHY non-relay
#   chiplets);
# * the chosen links fill their slots in the host's order (the MST's edges
#   by rank, then the augmentation's by rank), so the edge arrays equal the
#   host's slot for slot.
# ---------------------------------------------------------------------------


class HeteroGraphBatch:
    """Batched ``PHY positions -> stacked ScoreGraph arrays`` for one arch,
    on ``device``."""

    def __init__(self, arch: ArchSpec, device="cpu"):
        self.arch = arch
        self.device = dev = torch.device(device)
        n = len(arch.chiplets)
        phy_base, owner = _phy_layout(arch)
        Vp = int(phy_base[-1])
        self.Vp, self.N, self.V = Vp, n, Vp + 2 * n
        self.e_max = 2 * Vp
        self.L = Vp                   # undirected link slots (== host e_max/2)
        # Static candidate pairs, row-major upper-triangle (host order).
        pp, qq = np.nonzero(np.triu(np.ones((Vp, Vp), bool), k=1)
                            & (owner[:, None] != owner[None, :]))
        self.E = len(pp)
        self._u = torch.as_tensor(pp, device=dev)
        self._v = torch.as_tensor(qq, device=dev)
        # Working set: only the Ecap cheapest candidates enter the Borůvka /
        # augmentation scans.  Valid (<= max_link_mm) edges are sparse —
        # empirically < 5 * Vp even on dense corner placements — so 8 * Vp
        # leaves ample margin; the overflow flag triggers the exact host
        # fallback in the pipeline should a placement ever exceed it.
        self.Ecap = int(min(self.E, 8 * Vp))
        # Initial components: relay-internal (weight-0) unions pre-applied.
        comp0 = np.arange(Vp)
        for c in range(n):
            if arch.chiplets[c].relay:
                idx = np.nonzero(owner == c)[0]
                comp0[idx] = idx[0]
        self._comp0 = torch.as_tensor(comp0, device=dev)
        n_comp = len(np.unique(comp0))
        self._bor_rounds = max(1, int(np.ceil(np.log2(max(n_comp, 2)))))
        self._jump_rounds = int(np.ceil(np.log2(max(Vp, 2)))) + 1
        self._aug_rounds = Vp // 2
        self._owner = torch.as_tensor(owner, device=dev)
        self._W_static = torch.as_tensor(_static_W(arch, owner, Vp, n),
                                         device=dev)
        self._d2d = float(np.float32(arch.latency.d2d_cost()))
        # The host compares float32 lengths against this float32 limit.
        self._max_link = float(np.float32(arch.max_link_mm + 1e-9))

    def _candidates(self, pos: torch.Tensor):
        """pos [B, Vp, 2] -> the Ecap cheapest candidates of each row in
        Kruskal order: (eu, ev [B, Ecap] long, evalid [B, Ecap] bool,
        overflow [B] bool)."""
        d = pos[:, self._u] - pos[:, self._v]                 # [B, E, 2]
        if self.arch.distance == "manhattan":
            dist = d.abs().sum(-1)
        else:
            dist = (d ** 2).sum(-1).sqrt()
        valid = dist <= self._max_link
        overflow = valid.sum(1) > self.Ecap
        srt = torch.where(valid, dist, torch.inf).argsort(
            dim=1, stable=True)[:, :self.Ecap]
        return self._u[srt], self._v[srt], valid.gather(1, srt), overflow

    def _lengths(self, pos: torch.Tensor, su: torch.Tensor,
                 sv: torch.Tensor) -> torch.Tensor:
        """Link lengths as the host build writes them: in float64 from the
        float32 positions (``ArchSpec.dist``), rounded to float32."""
        def at(s):
            return pos.double().gather(1, s[:, :, None].expand(-1, -1, 2))
        d = at(su) - at(sv)
        if self.arch.distance == "manhattan":
            return d.abs().sum(-1).float()
        return (d ** 2).sum(-1).sqrt().float()

    def _boruvka(self, eu, ev, evalid):
        """Batched Borůvka over distinct ranks -> (MST edges [B, Ecap]
        bool, final component labels [B, Vp])."""
        B, Ec, Vp = eu.shape[0], self.Ecap, self.Vp
        rank = torch.arange(Ec, device=eu.device).expand(B, Ec)
        node = torch.arange(Vp, device=eu.device).expand(B, Vp)
        comp = self._comp0.expand(B, Vp)
        sel = torch.zeros_like(evalid)
        for _ in range(self._bor_rounds):
            cu, cv = comp.gather(1, eu), comp.gather(1, ev)
            cross = evalid & (cu != cv)
            r = torch.where(cross, rank, Ec)
            best = torch.full((B, Vp), Ec, device=eu.device)
            best.scatter_reduce_(1, cu, r, "amin")
            best.scatter_reduce_(1, cv, r, "amin")
            min_u = cross & (rank == best.gather(1, cu))  # unique per
            min_v = cross & (rank == best.gather(1, cv))  # component
            sel = sel | min_u | min_v
            # Each component points at the one across its cheapest edge
            # (slot Vp takes the writes of the other edges).
            ptr = torch.cat([node, node[:, :1]], 1)
            ptr.scatter_(1, torch.where(min_u, cu, Vp), cv)
            ptr.scatter_(1, torch.where(min_v, cv, Vp), cu)
            ptr = ptr[:, :Vp]
            # Star contraction: break the 2-cycles, then pointer-jump.
            ptr = torch.where((ptr.gather(1, ptr) == node) & (node < ptr),
                              node, ptr)
            for _ in range(self._jump_rounds):
                ptr = ptr.gather(1, ptr)
            comp = ptr.gather(1, comp)
        return sel, comp

    def _augment(self, eu, ev, evalid, sel):
        """The greedy augmentation as rounds of locally cheapest eligible
        edges -> [B, Ecap] bool."""
        B, Ec, Vp = eu.shape[0], self.Ecap, self.Vp
        rank = torch.arange(Ec, device=eu.device).expand(B, Ec)
        used = torch.zeros((B, Vp + 1), dtype=torch.bool, device=eu.device)
        used.scatter_(1, torch.where(sel, eu, Vp), True)
        used.scatter_(1, torch.where(sel, ev, Vp), True)
        aug = torch.zeros_like(sel)
        elig = evalid & ~sel & ~used.gather(1, eu) & ~used.gather(1, ev)
        for _ in range(self._aug_rounds):
            if not bool(elig.any()):
                break
            r = torch.where(elig, rank, Ec)
            best = torch.full((B, Vp), Ec, device=eu.device)
            best.scatter_reduce_(1, eu, r, "amin")
            best.scatter_reduce_(1, ev, r, "amin")
            take = elig & (best.gather(1, eu) == rank) \
                & (best.gather(1, ev) == rank)
            aug |= take
            used.scatter_(1, torch.where(take, eu, Vp), True)
            used.scatter_(1, torch.where(take, ev, Vp), True)
            elig &= ~used.gather(1, eu) & ~used.gather(1, ev)
        return aug

    def build(self, ppos: torch.Tensor, area: torch.Tensor) -> dict:
        """[B, Vp, 2] float32 PHY positions + [B] areas on the device ->
        batched ScoreGraph arrays: stack_graphs keys plus the
        component-derived ``connected`` [B] and an ``overflow`` [B] flag
        (candidate count above Ecap; the caller must recompute those rows
        host-side — they are vanishingly rare)."""
        B, Ec, L = ppos.shape[0], self.Ecap, self.L
        eu, ev, evalid, overflow = self._candidates(ppos)
        sel, comp = self._boruvka(eu, ev, evalid)
        aug = self._augment(eu, ev, evalid, sel)
        # Slots in the host's order: MST edges by rank, then augmentation
        # edges by rank, then the padding.
        rank = torch.arange(Ec, device=eu.device)
        key = torch.where(sel, rank, torch.where(aug, Ec + rank, 2 * Ec))
        take = key.argsort(dim=1, stable=True)[:, :L]
        smask = torch.arange(L, device=eu.device) < (sel | aug).sum(
            1, keepdim=True)
        su = torch.where(smask, eu.gather(1, take), 0)
        sv = torch.where(smask, ev.gather(1, take), 0)
        sl = torch.where(smask, self._lengths(ppos, su, sv), 0.0)
        vals = torch.where(smask, self._d2d, float(INF))
        edges, mask, edge_len = _both_ways(su, sv, smask, sl)
        # Fixed host connectivity rule: one component covers every chiplet.
        cov = torch.zeros((B, self.Vp * self.N), dtype=torch.bool,
                          device=eu.device)
        cov.scatter_(1, comp * self.N + self._owner, True)
        connected = cov.view(B, self.Vp, self.N).all(2).any(1)
        return dict(W=_scatter_links(self._W_static, su, sv, vals),
                    edges=edges, edge_mask=mask, edge_len=edge_len,
                    area=area.to(torch.float32), connected=connected,
                    overflow=overflow)
