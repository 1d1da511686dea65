"""3D homogeneous placement representation (stacked grids).

A placement is an R x C x Z grid of cells; each cell holds a compute-,
memory- or IO-chiplet or is empty.  The solution object is a pair of int8
numpy arrays ``(types, rot)`` of shape [R, C, Z] — the 2D representation
(``core.placement_homog.HomogRep``) with one more axis.  Rotation stays
*in-plane*: a 1-PHY chiplet's PHY faces N/E/S/W within its layer
(vertical TSV attachment ignores rotation, see ``arch3d.topology``).

``Homog3DRep`` hosts the four representation functions (random / mutate /
merge / score) with python-loop semantics mirroring ``HomogRep``, drawing
from a ``np.random.Generator`` exactly as the reference's do (the same
seed gives the same placements); ``Homog3DBatch`` is the device-resident
batched mirror on a ``torch.Generator`` (distribution-equivalent, not
draw for draw), and the ``device_stage_key`` / ``graph_batch`` /
``tier_values`` trio plugs the rep into ``optimize.DevicePipeline``
without the core ever importing this package.

The port of ``repro.arch3d.placement``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.chiplets import COMPUTE, IO, MEMORY, ArchSpec
from ..core.placement_homog import (first_true, onehot, permute_rows,
                                    uniform_pick)
from ..core.proxies import Layout, resolve_device
from ..core.topology import (DIR_DELTA as _DIR_DELTA, ROT_DIR as _ROT_DIR,
                             ScoreGraph)

from .topology import (Grid3DGraphBatch, default_tier_values, family_records,
                       score_graph3d_host)

Sol3D = tuple[np.ndarray, np.ndarray]   # (types [R,C,Z], rot [R,C,Z])

_KINDS = (COMPUTE, MEMORY, IO)
_SWAP_TRIES = 128    # host caps at 200 sequential tries; pre-drawn here
# Neighbor-mutation directions: the four in-plane grid directions plus
# up/down the stack, as (dr, dc, dz).
_DIRS3 = tuple([(_DIR_DELTA[d][0], _DIR_DELTA[d][1], 0) for d in _ROT_DIR]
               + [(0, 0, 1), (0, 0, -1)])


def sol_key3d(sol: Sol3D) -> bytes:
    return sol[0].tobytes() + sol[1].tobytes()


@dataclass
class Homog3DRep:
    """Placement representation + operators for stacked homogeneous grids.

    ``kind`` / ``cluster`` / ``augment`` select the arch family's static
    adjacency structure (see ``arch3d.topology.family_records``);
    ``tsv_slowdown`` / ``backbone_factor`` only scale the runtime tier
    latency vector (:attr:`tier_values`) — they are *excluded* from
    :meth:`device_stage_key`, so sweeping them shares compiled stages.
    """

    arch: ArchSpec
    R: int
    C: int
    Z: int
    mutation_mode: str = "neighbor-one"
    kind: str = "stack"                       # stack | gateway
    cluster: tuple[int, int] | None = None
    augment: str = "none"                     # none | torus | express | ...
    augment_params: dict = field(default_factory=dict)
    tsv_slowdown: float = 4.0
    backbone_factor: float = 2.0

    def __post_init__(self):
        n = len(self.arch.chiplets)
        if self.R * self.C * self.Z < n:
            raise ValueError("grid too small for chiplet count")
        self._kind_instances = {
            k: [i for i, ch in enumerate(self.arch.chiplets) if ch.kind == k]
            for k in _KINDS
        }
        self._phy_base = np.zeros(n + 1, dtype=np.int64)
        for i, ch in enumerate(self.arch.chiplets):
            self._phy_base[i + 1] = self._phy_base[i] + ch.n_phys()
        self._rotatable = {
            k: self.arch.chiplets[self._kind_instances[k][0]].n_phys() == 1
            for k in _KINDS if self._kind_instances[k]
        }
        self.records = tuple(family_records(
            self.arch, self.R, self.C, self.Z, kind=self.kind,
            cluster=self.cluster, augment=self.augment,
            augment_params=self.augment_params))
        # Per-cell rotation candidates, derived from the *family's* records
        # (not bare grid adjacency): ``_rot_other[cell][rot]`` lists the
        # cells a 1-PHY chiplet rotated to ``rot`` could link to.  Gateway
        # families exclude cross-cluster sides; torus/express wraps count —
        # without this, 1-PHY chiplets roll toward record-free sides and
        # connected gateway placements become vanishingly rare.
        cells = self.R * self.C * self.Z
        rot_other: list[list[list[int]]] = [
            [[] for _ in range(4)] for _ in range(cells)]
        for a in self.records:
            if a.rot1 >= 0:
                rot_other[a.cell1][a.rot1].append(a.cell2)
            if a.rot2 >= 0:
                rot_other[a.cell2][a.rot2].append(a.cell1)
        self._rot_other = rot_other

    # -- static properties -------------------------------------------------
    @property
    def layout(self) -> Layout:
        return Layout(Vp=int(self._phy_base[-1]), kinds=self.arch.kinds())

    @property
    def e_max(self) -> int:
        return 2 * len(self.records)

    @property
    def area(self) -> float:
        # The package footprint is one layer; stacking does not grow it.
        sz = self.arch.chiplets[0].w * self.arch.chiplets[0].h
        return float(sz * self.R * self.C)

    @property
    def tier_values(self) -> np.ndarray:
        """Runtime ``[W_INTRA, W_BACKBONE, W_VERTICAL]`` latency vector."""
        return default_tier_values(self.arch,
                                   tsv_slowdown=self.tsv_slowdown,
                                   backbone_factor=self.backbone_factor)

    @property
    def scorer_shape_key(self) -> tuple:
        """Splits ``api.get_scorer``'s cache between same-layout families
        with different edge-slot counts (stack3d32 vs torus3d32): stacked
        cross-run scoring groups by scorer identity, and unlike edge
        shapes cannot concatenate into one batch."""
        return ("arch3d-edges", 2 * len(self.records))

    # -- DevicePipeline plug-in surface -------------------------------------
    def device_stage_key(self) -> tuple:
        """Stage-cache key: everything that shapes the compiled stages.
        Tier latencies (tsv/backbone factors) are runtime operands and
        deliberately absent."""
        return ("arch3d", self.arch, self.R, self.C, self.Z,
                self.mutation_mode, self.kind, self.cluster, self.augment,
                tuple(sorted(self.augment_params.items())))

    def graph_batch(self, device=None) -> Grid3DGraphBatch:
        """The family's batched graph build on ``device`` (default: the
        card)."""
        return Grid3DGraphBatch(self.arch, self.R, self.C, self.Z,
                                list(self.records),
                                device=resolve_device(device))

    def batch_ops(self, device=None) -> "Homog3DBatch":
        """Cached batched operators on ``device`` (default: the card)."""
        dev = resolve_device(device)
        cache = self.__dict__.setdefault("_batch_ops", {})
        if str(dev) not in cache:
            cache[str(dev)] = Homog3DBatch(self, dev)
        return cache[str(dev)]

    # -- helpers -------------------------------------------------------------
    def _roll_rotation(self, types, r, c, z, rng) -> int:
        """Uniform rotation over the cell's record-backed candidates:
        rotations whose link partner is occupied, else rotations with any
        record, else all four (mirrors the 2D occupied -> inside -> all
        cascade, generalized to the family's adjacency)."""
        tflat = types.reshape(-1)
        cands_cell = self._rot_other[(r * self.C + c) * self.Z + z]
        occ = [rot for rot in range(4)
               if any(tflat[o] >= 0 for o in cands_cell[rot])]
        anyr = [rot for rot in range(4) if cands_cell[rot]]
        return int(rng.choice(occ or anyr or [0, 1, 2, 3]))

    def _fix_rotations(self, types, rot, rng) -> None:
        for r in range(self.R):
            for c in range(self.C):
                for z in range(self.Z):
                    k = types[r, c, z]
                    if k >= 0 and self._rotatable.get(int(k), False):
                        rot[r, c, z] = self._roll_rotation(types, r, c, z,
                                                           rng)
                    else:
                        rot[r, c, z] = 0

    # -- the four representation functions -----------------------------------
    def random(self, rng: np.random.Generator) -> Sol3D:
        cells = self.R * self.C * self.Z
        flat = np.full(cells, -1, dtype=np.int8)
        kinds = [k for k, ids in self._kind_instances.items() for _ in ids]
        pos = rng.choice(np.arange(cells), size=len(kinds), replace=False)
        flat[pos] = np.array(kinds, dtype=np.int8)
        types = flat.reshape(self.R, self.C, self.Z)
        rot = np.zeros_like(types)
        self._fix_rotations(types, rot, rng)
        return types, rot

    def mutate(self, sol: Sol3D, rng: np.random.Generator) -> Sol3D:
        types = sol[0].copy()
        rot = sol[1].copy()
        neighbor = self.mutation_mode.startswith("neighbor")
        both = self.mutation_mode.endswith("both")
        do_swap = True
        do_rot = both or not any(self._rotatable.values())
        if not both and any(self._rotatable.values()):
            do_swap = bool(rng.integers(2))
            do_rot = not do_swap
        if do_swap:
            self._swap(types, rot, rng, neighbor)
        if do_rot and any(self._rotatable.values()):
            self._rotate_one(types, rot, rng)
        return types, rot

    def _swap(self, types, rot, rng, neighbor: bool) -> None:
        for _ in range(200):
            r1 = int(rng.integers(self.R))
            c1 = int(rng.integers(self.C))
            z1 = int(rng.integers(self.Z))
            if neighbor:
                dr, dc, dz = _DIRS3[int(rng.integers(6))]
                r2, c2, z2 = r1 + dr, c1 + dc, z1 + dz
                if not (0 <= r2 < self.R and 0 <= c2 < self.C
                        and 0 <= z2 < self.Z):
                    continue
            else:
                r2 = int(rng.integers(self.R))
                c2 = int(rng.integers(self.C))
                z2 = int(rng.integers(self.Z))
            a, b = (r1, c1, z1), (r2, c2, z2)
            if types[a] == types[b]:
                continue
            if types[a] < 0 and types[b] < 0:
                continue
            types[a], types[b] = types[b], types[a]
            rot[a], rot[b] = rot[b], rot[a]
            for (r, c, z) in (a, b):
                k = types[r, c, z]
                if k >= 0 and self._rotatable.get(int(k), False):
                    rot[r, c, z] = self._roll_rotation(types, r, c, z, rng)
                else:
                    rot[r, c, z] = 0
            return

    def _rotate_one(self, types, rot, rng) -> None:
        cand = [(r, c, z) for r in range(self.R) for c in range(self.C)
                for z in range(self.Z)
                if types[r, c, z] >= 0
                and self._rotatable.get(int(types[r, c, z]), False)]
        if not cand:
            return
        r, c, z = cand[int(rng.integers(len(cand)))]
        rot[r, c, z] = self._roll_rotation(types, r, c, z, rng)

    def merge(self, a: Sol3D, b: Sol3D, rng: np.random.Generator) -> Sol3D:
        ta, ra_ = a
        tb, rb_ = b
        types = np.full_like(ta, -2)            # -2 = unresolved
        match = ta == tb
        types[match] = ta[match]
        remaining = {k: len(ids) for k, ids in self._kind_instances.items()}
        for k in remaining:
            remaining[k] -= int((types == k).sum())
        unresolved = np.argwhere(types == -2)
        fill = []
        for k, n in remaining.items():
            fill += [k] * n
        fill += [-1] * (len(unresolved) - len(fill))
        fill = np.array(fill, dtype=np.int8)
        rng.shuffle(fill)
        for (r, c, z), v in zip(unresolved, fill):
            types[r, c, z] = v
        rot = np.zeros_like(types)
        rot_match = match & (ra_ == rb_)
        rot[rot_match] = ra_[rot_match]
        for r in range(self.R):
            for c in range(self.C):
                for z in range(self.Z):
                    k = types[r, c, z]
                    if k >= 0 and self._rotatable.get(int(k), False):
                        if not rot_match[r, c, z]:
                            rot[r, c, z] = self._roll_rotation(
                                types, r, c, z, rng)
                    else:
                        rot[r, c, z] = 0
        return types, rot

    # -- scoring --------------------------------------------------------------
    def score_graph(self, sol: Sol3D) -> ScoreGraph:
        return score_graph3d_host(self.arch, self.records, sol[0], sol[1],
                                  self.tier_values, self.area)

    def is_connected(self, sol: Sol3D) -> bool:
        return bool(self.score_graph(sol).connected)


# ---------------------------------------------------------------------------
# Device-resident batched operators (the [B, R, C, Z] mirror of HomogBatch).
# ---------------------------------------------------------------------------


class Homog3DBatch:
    """Vectorized ``random/mutate/merge`` over stacked 3D grids on
    ``device``, drawing from a ``torch.Generator`` there."""

    def __init__(self, rep: Homog3DRep, device):
        self.rep = rep
        self.device = dev = torch.device(device)
        self.R, self.C, self.Z = rep.R, rep.C, rep.Z
        self.cells = rep.R * rep.C * rep.Z
        fill = [k for k, ids in rep._kind_instances.items() for _ in ids]
        fill += [-1] * (self.cells - len(fill))
        self._kinds_fill = torch.as_tensor(np.array(fill, dtype=np.int8),
                                           device=dev)
        self._counts = [len(rep._kind_instances.get(k, ())) for k in _KINDS]
        rotatable = np.array([bool(rep._rotatable.get(k, False))
                              for k in _KINDS])
        self._rotatable_kind = torch.as_tensor(rotatable, device=dev)
        self._any_rotatable = bool(rotatable.any())
        # Record-backed rotation candidates, padded to a rectangular
        # gather table: ``_rot_other_idx[cell, rot]`` lists link-partner
        # cells (sentinel ``cells`` = an always-unoccupied pad slot).
        M = max(1, max(len(s) for cell in rep._rot_other for s in cell))
        other = np.full((self.cells, 4, M), self.cells, np.int64)
        any_rec = np.zeros((self.cells, 4), bool)
        for cell, per_rot in enumerate(rep._rot_other):
            for rot_i, partners in enumerate(per_rot):
                other[cell, rot_i, :len(partners)] = partners
                any_rec[cell, rot_i] = bool(partners)
        self._rot_other_idx = torch.as_tensor(other, device=dev)
        self._rot_any = torch.as_tensor(any_rec, device=dev)
        self._d6 = [torch.tensor([d[i] for d in _DIRS3], device=dev)
                    for i in range(3)]

    # -- rotation re-roll (vectorized ``_fix_rotations``) --------------------
    def _rotatable_cells(self, types: torch.Tensor) -> torch.Tensor:
        kind = types.clamp(0, 2).long()
        return (types >= 0) & self._rotatable_kind[kind]

    def _roll_rot_batch(self, gen, types, rot, update) -> torch.Tensor:
        """Uniform re-roll over each cell's record-backed candidate
        rotations under ``update`` (the host ``_roll_rotation`` cascade:
        partner-occupied -> any-record -> all 4); other updated cells get
        0, cells outside ``update`` keep ``rot``."""
        shape = types.shape
        B = shape[0]
        occ = (types >= 0).reshape(B, self.cells)
        occ_pad = torch.cat([occ, torch.zeros(B, 1, dtype=torch.bool,
                                              device=occ.device)], 1)
        cand_occ = occ_pad[:, self._rot_other_idx].any(-1)
        rot_any = self._rot_any.expand_as(cand_occ)
        cand = torch.where(cand_occ.any(-1, keepdim=True), cand_occ,
                           torch.where(rot_any.any(-1, keepdim=True),
                                       rot_any, True))
        new = uniform_pick(gen, cand).to(torch.int8).reshape(shape)
        rotatable = self._rotatable_cells(types)
        return torch.where(update & rotatable, new,
                           torch.where(update, 0, rot).to(torch.int8))

    # -- the representation functions, batched -------------------------------
    def random_batch(self, gen: torch.Generator, n: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """n independent uniform placements: a random permutation of the
        chiplet-kind multiset over the cells, rotations re-rolled."""
        types = permute_rows(gen, self._kinds_fill, n).reshape(
            n, self.R, self.C, self.Z)
        rot = self._roll_rot_batch(gen, types, torch.zeros_like(types),
                                   torch.ones(types.shape, dtype=torch.bool,
                                              device=self.device))
        return types, rot

    def mutate_batch(self, gen: torch.Generator, types, rot
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched ``mutate``: per placement either a (neighbor-)swap of two
        differing cells (six directions: four in-plane, up and down the
        stack) or a re-roll of one rotatable chiplet (or both, per
        ``mutation_mode``), with the host's first-valid-try semantics."""
        B, dev = types.shape[0], self.device
        R, C, Z = self.R, self.C, self.Z
        neighbor = self.rep.mutation_mode.startswith("neighbor")
        both = self.rep.mutation_mode.endswith("both")
        if both or not self._any_rotatable:
            do_swap = torch.ones(B, dtype=torch.bool, device=dev)
        else:
            do_swap = torch.rand(B, generator=gen, device=dev) < 0.5
        if not self._any_rotatable:
            do_rot = torch.zeros(B, dtype=torch.bool, device=dev)
        elif both:
            do_rot = torch.ones(B, dtype=torch.bool, device=dev)
        else:
            do_rot = ~do_swap
        # Pre-drawn swap tries; the first valid one is the host's accepted
        # draw (identical first-success distribution).
        shape = (B, _SWAP_TRIES)
        r1 = torch.randint(0, R, shape, generator=gen, device=dev)
        c1 = torch.randint(0, C, shape, generator=gen, device=dev)
        z1 = torch.randint(0, Z, shape, generator=gen, device=dev)
        if neighbor:
            d = torch.randint(0, 6, shape, generator=gen, device=dev)
            r2, c2, z2 = (x + dx[d] for x, dx in zip((r1, c1, z1), self._d6))
        else:
            r2 = torch.randint(0, R, shape, generator=gen, device=dev)
            c2 = torch.randint(0, C, shape, generator=gen, device=dev)
            z2 = torch.randint(0, Z, shape, generator=gen, device=dev)
        inb = ((r2 >= 0) & (r2 < R) & (c2 >= 0) & (c2 < C)
               & (z2 >= 0) & (z2 < Z))
        i1 = (r1 * C + c1) * Z + z1
        i2 = ((r2.clamp(0, R - 1) * C + c2.clamp(0, C - 1)) * Z
              + z2.clamp(0, Z - 1))
        tflat = types.reshape(B, self.cells).clone()
        rflat = rot.reshape(B, self.cells).clone()
        t1 = tflat.gather(1, i1)
        t2 = tflat.gather(1, i2)
        valid = inb & (t1 != t2) & ~((t1 < 0) & (t2 < 0))
        first = first_true(valid)[:, None]
        do_it = do_swap & valid.any(1)
        s1 = torch.where(do_it, i1.gather(1, first)[:, 0], 0)
        s2 = torch.where(do_it, i2.gather(1, first)[:, 0], 0)  # no-op swap
        b = torch.arange(B, device=dev)
        for flat in (tflat, rflat):
            v1, v2 = flat[b, s1], flat[b, s2]
            flat[b, s1] = v2
            flat[b, s2] = v1
        update = (onehot(s1, do_it, self.cells)
                  | onehot(s2, do_it, self.cells))
        if self._any_rotatable:
            rc = self._rotatable_cells(tflat)
            pick = uniform_pick(gen, rc)
            update |= onehot(pick, do_rot & rc.any(1), self.cells)
        shape = (B, R, C, Z)
        types2 = tflat.reshape(shape)
        rot2 = self._roll_rot_batch(gen, types2, rflat.reshape(shape),
                                    update.reshape(shape))
        return types2, rot2

    def merge_batch(self, gen: torch.Generator, ta, ra, tb, rb
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched merge: keep agreeing cells, distribute the leftover
        chiplets uniformly over the disagreeing cells (random-rank fill ==
        host's shuffled fill), carry rotations only where both agree."""
        B = ta.shape[0]
        match = ta == tb
        taf = ta.reshape(B, self.cells)
        mf = match.reshape(B, self.cells)
        carried = torch.where(mf, taf, -2)
        rem = [self._counts[k] - (carried == k).sum(1) for k in range(3)]
        prio = torch.rand((B, self.cells), generator=gen, device=self.device)
        prio = torch.where(carried == -2, prio, 2.0)  # resolved cells: last
        rank = prio.argsort(dim=1, stable=True).argsort(1)
        c0 = rem[0][:, None]
        c1 = c0 + rem[1][:, None]
        c2 = c1 + rem[2][:, None]
        fill = torch.where(rank < c0, COMPUTE,
                           torch.where(rank < c1, MEMORY,
                                       torch.where(rank < c2, IO, -1)))
        types = torch.where(mf, taf, fill.to(ta.dtype))
        types = types.reshape(B, self.R, self.C, self.Z)
        rot_match = match & (ra == rb)
        rot0 = torch.where(rot_match, ra, 0).to(ra.dtype)
        update = ~(rot_match & self._rotatable_cells(types))
        return types, self._roll_rot_batch(gen, types, rot0, update)
