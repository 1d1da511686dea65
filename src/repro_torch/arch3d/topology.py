"""Tiered static-adjacency ScoreGraph assembly for 3D / hierarchical grids.

The 2D homogeneous builder (``core.topology.HomogGraphBatch``) exploits the
fact that an R x C grid's candidate-link structure is *static*: each cell
adjacency either carries a D2D link (both facing PHYs exist) or not, so
link inference is masked selection over a fixed adjacency table.  This
module generalizes that trick along three axes at once:

* **a third grid dimension** — placements are ``[R, C, Z]``; vertical
  (TSV) adjacencies join the same cell across layers,
* **weight tiers** — every adjacency carries a tier index
  (``TIER_PLANAR`` / ``TIER_BACKBONE`` / ``TIER_VERTICAL``) and the tier
  latency values enter :meth:`Grid3DGraphBatch.build` as a *runtime*
  ``[3]`` operand (like ``edge_len`` / norms / weights), so reps that
  differ only in ``tsv_slowdown`` or backbone factors share one builder,
* **pluggable adjacency generation** — a family is just a list of
  :class:`AdjRecord`; ``stack`` families use the full planar mesh + TSV
  pillars, ``gateway`` families keep planar links intra-cluster and join
  clusters only through per-cluster gateway PHYs
  (``W_INTRA < W_BACKBONE < W_VERTICAL``), and registered *augmentations*
  (``torus`` wraparound, ``express`` skip links — the
  ``@register_augmentation`` registry) add long-range candidates instead
  of the paper's greedy leftover-PHY augmentation.

PHY attachment per adjacency endpoint: a planar endpoint names the facing
side (4-PHY chiplets use that side's PHY; 1-PHY chiplets participate only
when rotated to face it); a vertical endpoint (``loc == -1``) attaches at
the chiplet's first PHY regardless of rotation — the TSV is a through-die
via, not a shoreline PHY.

``score_graph3d_host`` is the independent host reference (python loops,
same padded slot layout) the device builder is tested bit-for-bit against.

The port of ``repro.arch3d.topology``: the records, the augmentations,
the tier values and the host reference are numpy as there;
:class:`Grid3DGraphBatch` builds on a torch device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.chiplets import ArchSpec
from ..core.registries import AUGMENTATIONS, register_augmentation
from ..core.topology import (DIR_DELTA, INF, OPP_DIR, ROT_DIR, ScoreGraph,
                             _both_ways, _phy_layout, _scatter_links,
                             _UnionFind)

TIER_PLANAR, TIER_BACKBONE, TIER_VERTICAL = 0, 1, 2
N_TIERS = 3


@dataclass(frozen=True)
class AdjRecord:
    """One static candidate adjacency of a 3D grid family.

    ``cell1``/``cell2`` are flat cell ids ``(r * C + c) * Z + z``;
    ``loc1``/``loc2`` the facing side's ``"nesw"`` local PHY index or -1
    for a vertical (any-PHY) attachment; ``rot1``/``rot2`` the rotation a
    1-PHY chiplet must have to participate (-1 = any); ``tier`` indexes
    the runtime tier-latency vector; ``length`` is the in-plane mm gap
    between the attachment points (0.0 for touching cells and TSVs).
    """

    cell1: int
    cell2: int
    loc1: int
    loc2: int
    rot1: int
    rot2: int
    tier: int
    length: float


def _cid(r: int, c: int, z: int, C: int, Z: int) -> int:
    return (r * C + c) * Z + z


def _side_mid(r: int, c: int, side: str, sz: float) -> tuple[float, float]:
    """In-plane mm position of a cell side's midpoint (the PHY spot)."""
    mids = {"n": (sz / 2, sz), "s": (sz / 2, 0.0),
            "e": (sz, sz / 2), "w": (0.0, sz / 2)}
    mx, my = mids[side]
    return (c * sz + mx, r * sz + my)


def _planar_record(arch: ArchSpec, r, c, z, rr, cc, d: str, C, Z,
                   tier: int) -> AdjRecord:
    o = OPP_DIR[d]
    sz = arch.chiplets[0].w
    length = arch.dist(_side_mid(r, c, d, sz), _side_mid(rr, cc, o, sz))
    return AdjRecord(cell1=_cid(r, c, z, C, Z), cell2=_cid(rr, cc, z, C, Z),
                     loc1="nesw".index(d), loc2="nesw".index(o),
                     rot1=ROT_DIR.index(d), rot2=ROT_DIR.index(o),
                     tier=tier, length=float(length))


def grid3d_adjacency(arch: ArchSpec, R: int, C: int, Z: int, *,
                     kind: str = "stack",
                     cluster: tuple[int, int] | None = None
                     ) -> list[AdjRecord]:
    """Base adjacency records of a 3D grid family (augmentations ride on
    top via the ``AUGMENTATIONS`` registry).

    ``stack``: the full planar mesh per layer (``TIER_PLANAR``) plus a TSV
    pillar per cell (``TIER_VERTICAL``).  ``gateway``: planar adjacencies
    only *within* a ``cluster = (cr, cc)`` tile; clusters are joined by
    backbone links between the gateway cells (each cluster's low corner)
    of grid-adjacent clusters (``TIER_BACKBONE``), and TSVs exist only at
    gateways — traffic between clusters or layers must route through the
    gateway hierarchy.
    """
    if kind not in ("stack", "gateway"):
        raise ValueError(f"unknown 3D family kind {kind!r}")
    if kind == "gateway":
        if cluster is None:
            raise ValueError("gateway families need cluster=(cr, cc)")
        cr, cc = cluster
        if R % cr or C % cc:
            raise ValueError(f"cluster {cluster} does not tile {R}x{C}")
    recs: list[AdjRecord] = []
    sz = arch.chiplets[0].w
    is_gw = (lambda r, c: r % cr == 0 and c % cc == 0) \
        if kind == "gateway" else (lambda r, c: True)
    for z in range(Z):
        # Planar adjacencies, each scanned once ("n"/"e") like the 2D rep.
        for r in range(R):
            for c in range(C):
                for d in ("n", "e"):
                    dr, dc = DIR_DELTA[d]
                    rr, cc2 = r + dr, c + dc
                    if not (0 <= rr < R and 0 <= cc2 < C):
                        continue
                    if kind == "gateway" and \
                            (r // cr, c // cc) != (rr // cr, cc2 // cc):
                        continue      # cross-cluster mesh link: backbone only
                    recs.append(_planar_record(arch, r, c, z, rr, cc2, d,
                                               C, Z, TIER_PLANAR))
        # Backbone links between grid-adjacent clusters' gateways.
        if kind == "gateway":
            for br in range(R // cr):
                for bc in range(C // cc):
                    r0, c0 = br * cr, bc * cc
                    if bc + 1 < C // cc:        # east neighbor cluster
                        c1 = (bc + 1) * cc
                        length = arch.dist(_side_mid(r0, c0, "e", sz),
                                           _side_mid(r0, c1, "w", sz))
                        recs.append(AdjRecord(
                            cell1=_cid(r0, c0, z, C, Z),
                            cell2=_cid(r0, c1, z, C, Z),
                            loc1="nesw".index("e"), loc2="nesw".index("w"),
                            rot1=ROT_DIR.index("e"), rot2=ROT_DIR.index("w"),
                            tier=TIER_BACKBONE, length=float(length)))
                    if br + 1 < R // cr:        # north neighbor cluster
                        r1 = (br + 1) * cr
                        length = arch.dist(_side_mid(r0, c0, "n", sz),
                                           _side_mid(r1, c0, "s", sz))
                        recs.append(AdjRecord(
                            cell1=_cid(r0, c0, z, C, Z),
                            cell2=_cid(r1, c0, z, C, Z),
                            loc1="nesw".index("n"), loc2="nesw".index("s"),
                            rot1=ROT_DIR.index("n"), rot2=ROT_DIR.index("s"),
                            tier=TIER_BACKBONE, length=float(length)))
    # Vertical TSV pillars (every cell for stacks, gateways only for the
    # hierarchy).  loc/rot -1: attach at the chiplet's first PHY.
    for r in range(R):
        for c in range(C):
            if not is_gw(r, c):
                continue
            for z in range(Z - 1):
                recs.append(AdjRecord(
                    cell1=_cid(r, c, z, C, Z), cell2=_cid(r, c, z + 1, C, Z),
                    loc1=-1, loc2=-1, rot1=-1, rot2=-1,
                    tier=TIER_VERTICAL, length=0.0))
    return recs


@register_augmentation("torus")
def torus_augment(R: int, C: int, Z: int, sz_mm: float,
                  params: dict) -> list[AdjRecord]:
    """Wraparound candidate links per layer: row wrap
    ``(r, C-1) e <-> (r, 0) w`` and column wrap ``(R-1, c) n <-> (0, c) s``
    (``TIER_BACKBONE``; the wrap length is the physical span)."""
    recs = []
    for z in range(Z):
        for r in range(R):
            if C > 2:     # C == 2 wrap duplicates the mesh adjacency
                recs.append(AdjRecord(
                    cell1=_cid(r, C - 1, z, C, Z), cell2=_cid(r, 0, z, C, Z),
                    loc1="nesw".index("e"), loc2="nesw".index("w"),
                    rot1=ROT_DIR.index("e"), rot2=ROT_DIR.index("w"),
                    tier=TIER_BACKBONE, length=float(C * sz_mm)))
        for c in range(C):
            if R > 2:
                recs.append(AdjRecord(
                    cell1=_cid(R - 1, c, z, C, Z), cell2=_cid(0, c, z, C, Z),
                    loc1="nesw".index("n"), loc2="nesw".index("s"),
                    rot1=ROT_DIR.index("n"), rot2=ROT_DIR.index("s"),
                    tier=TIER_BACKBONE, length=float(R * sz_mm)))
    return recs


@register_augmentation("express")
def express_augment(R: int, C: int, Z: int, sz_mm: float,
                    params: dict) -> list[AdjRecord]:
    """Express skip links per layer: ``(r, c) <-> (r, c + stride)`` and
    ``(r, c) <-> (r + stride, c)`` (default stride 2, ``TIER_BACKBONE``) —
    the SW3D-style long-range shortcuts."""
    stride = int(params.get("stride", 2))
    if stride < 2:
        raise ValueError("express stride must be >= 2")
    recs = []
    for z in range(Z):
        for r in range(R):
            for c in range(C - stride):
                recs.append(AdjRecord(
                    cell1=_cid(r, c, z, C, Z),
                    cell2=_cid(r, c + stride, z, C, Z),
                    loc1="nesw".index("e"), loc2="nesw".index("w"),
                    rot1=ROT_DIR.index("e"), rot2=ROT_DIR.index("w"),
                    tier=TIER_BACKBONE,
                    length=float((stride - 1) * sz_mm)))
        for c in range(C):
            for r in range(R - stride):
                recs.append(AdjRecord(
                    cell1=_cid(r, c, z, C, Z),
                    cell2=_cid(r + stride, c, z, C, Z),
                    loc1="nesw".index("n"), loc2="nesw".index("s"),
                    rot1=ROT_DIR.index("n"), rot2=ROT_DIR.index("s"),
                    tier=TIER_BACKBONE,
                    length=float((stride - 1) * sz_mm)))
    return recs


def family_records(arch: ArchSpec, R: int, C: int, Z: int, *,
                   kind: str = "stack",
                   cluster: tuple[int, int] | None = None,
                   augment: str = "none",
                   augment_params: dict | None = None) -> list[AdjRecord]:
    """Base adjacency + the named registered augmentation's candidates."""
    recs = grid3d_adjacency(arch, R, C, Z, kind=kind, cluster=cluster)
    if augment != "none":
        fn = AUGMENTATIONS.get(augment)
        recs = recs + fn(R, C, Z, arch.chiplets[0].w, augment_params or {})
    return recs


def default_tier_values(arch: ArchSpec, *, tsv_slowdown: float = 4.0,
                        backbone_factor: float = 2.0) -> np.ndarray:
    """Tier latency vector ``[W_INTRA, W_BACKBONE, W_VERTICAL]`` [cycles].

    A D2D hop always crosses two PHYs; the tier scales only the *link*
    part: planar = ``2*l_phy + l_link``, backbone = ``2*l_phy +
    l_link*backbone_factor`` (longer span / serialized hierarchy link),
    vertical = ``2*l_phy + l_link*tsv_slowdown`` (TSV slowdown).  With the
    defaults (l_phy 12, l_link 1): 25 < 26 < 28.
    """
    lp, ll = arch.latency.l_phy, arch.latency.l_link
    return np.array([2.0 * lp + ll,
                     2.0 * lp + ll * backbone_factor,
                     2.0 * lp + ll * tsv_slowdown], np.float32)


# ---------------------------------------------------------------------------
# Device builder.
# ---------------------------------------------------------------------------


class Grid3DGraphBatch:
    """Batched ``(types, rot[, tiers]) -> stacked ScoreGraph arrays`` for
    one 3D grid family (its static :class:`AdjRecord` list), on
    ``device``."""

    def __init__(self, arch: ArchSpec, R: int, C: int, Z: int,
                 records: list[AdjRecord],
                 tier_values: np.ndarray | None = None, device="cpu"):
        self.arch, self.R, self.C, self.Z = arch, R, C, Z
        self.records = tuple(records)
        self.device = dev = torch.device(device)
        n = len(arch.chiplets)
        phy_base, _ = _phy_layout(arch)
        Vp = int(phy_base[-1])
        self.Vp, self.N = Vp, n
        self.V = Vp + 2 * n
        self.e_max = 2 * len(records)
        self._nphys = torch.tensor([ch.n_phys() for ch in arch.chiplets],
                                   device=dev)
        self._phy_base = torch.as_tensor(phy_base[:-1], device=dev)
        by_kind = {k: [i for i, ch in enumerate(arch.chiplets)
                       if ch.kind == k] for k in (0, 1, 2)}
        maxc = max(1, max(len(v) for v in by_kind.values()))
        table = np.zeros((3, maxc), np.int64)
        for k, ids in by_kind.items():
            table[k, :len(ids)] = ids
        self._kind_table = torch.as_tensor(table, device=dev)
        self._W_static = torch.as_tensor(static_weight_matrix(arch),
                                         device=dev)

        def col(name):
            return torch.tensor([getattr(a, name) for a in records],
                                dtype=torch.long, device=dev)

        self._a_cell1, self._a_cell2 = col("cell1"), col("cell2")
        self._a_loc1, self._a_loc2 = col("loc1"), col("loc2")
        self._a_rot1, self._a_rot2 = col("rot1"), col("rot2")
        self._a_tier = col("tier")
        self._a_len = torch.as_tensor(
            np.array([a.length for a in records], np.float32), device=dev)
        self._tiers_default = torch.as_tensor(
            default_tier_values(arch) if tier_values is None
            else np.asarray(tier_values, np.float32), device=dev)
        # §V-A get_area on the stacked package: the *footprint* is one
        # layer's R x C cells — stacking Z layers does not grow it.
        sz = arch.chiplets[0].w * arch.chiplets[0].h
        self.area = float(np.float32(sz * R * C))

    def _instances(self, tflat: torch.Tensor) -> torch.Tensor:
        """Flat-scan instance ids per cell ([B, cells], -1 for empty)."""
        inst = torch.full(tflat.shape, -1, dtype=torch.long,
                          device=tflat.device)
        for k in range(3):
            mk = tflat == k
            rank = (mk.cumsum(1) - 1).clamp(0, self._kind_table.shape[1] - 1)
            inst = torch.where(mk, self._kind_table[k][rank], inst)
        return inst

    def _phy_at(self, inst, rot, loc4, rotidx):
        """Global PHY index facing the adjacency (or -1).  ``loc4 == -1``
        (vertical attachment) resolves to the chiplet's first PHY for any
        rotation."""
        ic = inst.clamp_min(0)
        base = self._phy_base[ic]
        planar = torch.where(self._nphys[ic] == 4, base + loc4.clamp_min(0),
                             torch.where(rot == rotidx, base, -1))
        return torch.where(loc4 < 0, base, planar)

    def build(self, types: torch.Tensor, rot: torch.Tensor,
              tiers: torch.Tensor | None = None) -> dict:
        """[B, R, C, Z] stacked placements on the device -> batched
        ScoreGraph arrays (the keys of ``stack_graphs``), equal to
        :func:`score_graph3d_host`'s slot for slot: slots 2k / 2k+1 are
        record k's pq / qp rows, zero where the adjacency is not realised.
        ``tiers`` is the runtime ``[N_TIERS]`` latency vector (default: the
        construction-time values)."""
        B = types.shape[0]
        tflat = types.reshape(B, -1).long()
        rflat = rot.reshape(B, -1).long()
        tiers = (self._tiers_default if tiers is None
                 else torch.as_tensor(tiers, dtype=torch.float32,
                                      device=self.device))
        inst = self._instances(tflat)
        i1 = inst[:, self._a_cell1]
        i2 = inst[:, self._a_cell2]
        p = self._phy_at(i1, rflat[:, self._a_cell1], self._a_loc1,
                         self._a_rot1)
        q = self._phy_at(i2, rflat[:, self._a_cell2], self._a_loc2,
                         self._a_rot2)
        valid = (i1 >= 0) & (i2 >= 0) & (p >= 0) & (q >= 0)
        pu = torch.where(valid, p, 0)
        qu = torch.where(valid, q, 0)
        vals = torch.where(valid, tiers[self._a_tier][None, :], float(INF))
        elen = torch.where(valid, self._a_len[None, :], 0.0)
        edges, mask, edge_len = _both_ways(pu, qu, valid, elen)
        return dict(W=_scatter_links(self._W_static, pu, qu, vals),
                    edges=edges, edge_mask=mask, edge_len=edge_len,
                    area=torch.full((B,), self.area, dtype=torch.float32,
                                    device=types.device))


def static_weight_matrix(arch: ArchSpec) -> np.ndarray:
    """Placement-independent part of W (diagonal, internal relay edges,
    virtual source/sink edges) — shared by the device builder and the host
    reference."""
    n = len(arch.chiplets)
    phy_base = np.zeros(n + 1, dtype=np.int64)
    for i, ch in enumerate(arch.chiplets):
        phy_base[i + 1] = phy_base[i] + ch.n_phys()
    Vp = int(phy_base[-1])
    V = Vp + 2 * n
    owner = np.zeros(Vp, dtype=np.int64)
    for i in range(n):
        owner[phy_base[i]:phy_base[i + 1]] = i
    W = np.full((V, V), INF, dtype=np.float32)
    np.fill_diagonal(W, 0.0)
    lr = np.float32(arch.latency.l_relay)
    for c in range(n):
        idx = np.nonzero(owner == c)[0]
        if arch.chiplets[c].relay:
            for a in range(len(idx)):
                for b in range(a + 1, len(idx)):
                    p, q = int(idx[a]), int(idx[b])
                    W[p, q] = min(W[p, q], lr)
                    W[q, p] = min(W[q, p], lr)
        W[Vp + c, idx] = 0.0
        W[idx, Vp + n + c] = 0.0
    return W


# ---------------------------------------------------------------------------
# Host reference (independent python-loop implementation, same slot layout).
# ---------------------------------------------------------------------------


def _host_instances(arch: ArchSpec, tflat: np.ndarray) -> np.ndarray:
    """Flat-scan instance assignment: the j-th cell of kind k gets the
    arch's j-th chiplet instance of that kind."""
    by_kind = {k: [i for i, ch in enumerate(arch.chiplets) if ch.kind == k]
               for k in (0, 1, 2)}
    counters = {k: 0 for k in by_kind}
    inst = np.full(tflat.shape, -1, np.int64)
    for j, k in enumerate(tflat):
        k = int(k)
        if k < 0:
            continue
        inst[j] = by_kind[k][counters[k]]
        counters[k] += 1
    return inst


def _host_phy(arch: ArchSpec, phy_base: np.ndarray, inst: int, rot: int,
              loc4: int, rotidx: int) -> int:
    if inst < 0:
        return -1
    base = int(phy_base[inst])
    if loc4 < 0:                       # vertical: first PHY, any rotation
        return base
    if arch.chiplets[inst].n_phys() == 4:
        return base + loc4
    return base if rot == rotidx else -1


def score_graph3d_host(arch: ArchSpec, records, types: np.ndarray,
                       rot: np.ndarray, tier_values: np.ndarray,
                       area: float) -> ScoreGraph:
    """Host reference: one placement -> ScoreGraph with the device
    builder's padded slot layout (slot 2k/2k+1 = record k's pq/qp rows,
    zeroed when the adjacency is not realized), so stacked host graphs
    compare bit-for-bit against :meth:`Grid3DGraphBatch.build`."""
    n = len(arch.chiplets)
    phy_base = np.zeros(n + 1, dtype=np.int64)
    for i, ch in enumerate(arch.chiplets):
        phy_base[i + 1] = phy_base[i] + ch.n_phys()
    tflat = np.asarray(types).reshape(-1)
    rflat = np.asarray(rot).reshape(-1)
    inst = _host_instances(arch, tflat)
    W = static_weight_matrix(arch).copy()
    A = len(records)
    edges = np.zeros((2 * A, 2), np.int32)
    mask = np.zeros((2 * A,), bool)
    elen = np.zeros((2 * A,), np.float32)
    tiers = np.asarray(tier_values, np.float32)
    links: list[tuple[int, int]] = []
    for k, a in enumerate(records):
        p = _host_phy(arch, phy_base, int(inst[a.cell1]),
                      int(rflat[a.cell1]), a.loc1, a.rot1)
        q = _host_phy(arch, phy_base, int(inst[a.cell2]),
                      int(rflat[a.cell2]), a.loc2, a.rot2)
        if p < 0 or q < 0:
            continue
        v = np.float32(tiers[a.tier])
        W[p, q] = min(W[p, q], v)
        W[q, p] = min(W[q, p], v)
        edges[2 * k] = (p, q)
        edges[2 * k + 1] = (q, p)
        mask[2 * k] = mask[2 * k + 1] = True
        elen[2 * k] = elen[2 * k + 1] = np.float32(a.length)
        links.append((int(inst[a.cell1]), int(inst[a.cell2])))
    # Chiplet-level connectivity (planar + vertical links both count).
    uf = _UnionFind(n)
    for u, v in links:
        uf.union(u, v)
    present = [int(i) for i in inst if i >= 0]
    connected = len({uf.find(i) for i in present}) == 1 if present else False
    return ScoreGraph(W=W, edges=edges, edge_mask=mask,
                      area=np.float32(area), connected=connected,
                      edge_len=elen)
