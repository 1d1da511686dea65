"""Homogeneous placement representation (paper §V-A, Fig. 5).

A placement is an R x C grid; each cell holds a compute-, memory- or
IO-chiplet or is empty.  All chiplets are 3mm x 3mm.  Chiplets with a single
PHY (memory/IO in the *baseline* chiplet configuration) can be rotated so the
PHY faces N/E/S/W; chiplets with four PHYs cannot (isomorphic placements).

The solution object is a pair of int8 numpy arrays ``(types, rot)`` of shape
[R, C]; ``types`` holds -1 for empty or the chiplet kind, ``rot`` in {0..3}
encodes the facing direction of single-PHY chiplets (0=S, 1=E, 2=N, 3=W —
matching ``Chiplet.rotated``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .chiplets import COMPUTE, IO, MEMORY, ArchSpec
from .proxies import Layout
from .topology import (DIR_DELTA as _DIR_DELTA, OPP_DIR as _OPP,
                       ROT_DIR as _ROT_DIR, PlacedPhys, ScoreGraph,
                       _UnionFind, build_score_graph)


Sol = tuple[np.ndarray, np.ndarray]  # (types [R,C], rot [R,C])


def sol_key(sol: Sol) -> bytes:
    return sol[0].tobytes() + sol[1].tobytes()


def hex_mask(side: int) -> np.ndarray:
    """Allowed-cell mask for a centered-hexagonal arrangement of ``side`` s:
    2s-1 rows of widths s, s+1, ..., 2s-1, ..., s+1, s (3s^2 - 3s + 1 cells,
    s=7 -> 127) centered on a (2s-1) x (2s-1) grid — the HexaMesh layout
    expressed on the square-grid representation."""
    n = 2 * side - 1
    mask = np.zeros((n, n), dtype=bool)
    for r in range(n):
        width = n - abs(r - (side - 1))
        lo = (n - width) // 2
        mask[r, lo:lo + width] = True
    return mask


@dataclass
class HomogRep:
    """Placement representation + operators for homogeneous chiplet shapes."""

    arch: ArchSpec
    R: int
    C: int
    mutation_mode: str = "neighbor-one"   # any-both | any-one | neighbor-both | neighbor-one
    allowed: np.ndarray | None = None     # [R, C] bool cell mask (None = all)

    def __post_init__(self):
        n = len(self.arch.chiplets)
        if self.allowed is not None:
            self.allowed = np.asarray(self.allowed, dtype=bool)
            if self.allowed.shape != (self.R, self.C):
                raise ValueError("allowed mask shape != (R, C)")
            if self.allowed.all():
                self.allowed = None       # degenerate mask == no mask
        n_cells = (self.R * self.C if self.allowed is None
                   else int(self.allowed.sum()))
        if n_cells < n:
            raise ValueError("grid too small for chiplet count")
        self._kind_instances = {
            k: [i for i, ch in enumerate(self.arch.chiplets) if ch.kind == k]
            for k in (COMPUTE, MEMORY, IO)
        }
        self._phy_base = np.zeros(n + 1, dtype=np.int64)
        for i, ch in enumerate(self.arch.chiplets):
            self._phy_base[i + 1] = self._phy_base[i] + ch.n_phys()
        self._rotatable = {
            k: self.arch.chiplets[self._kind_instances[k][0]].n_phys() == 1
            for k in (COMPUTE, MEMORY, IO) if self._kind_instances[k]
        }

    # -- static properties ---------------------------------------------------
    @property
    def layout(self) -> Layout:
        return Layout(Vp=int(self._phy_base[-1]), kinds=self.arch.kinds())

    @property
    def e_max(self) -> int:
        return 2 * (self.R * (self.C - 1) + (self.R - 1) * self.C)

    @property
    def area(self) -> float:
        # §V-A get_area: chiplet_size * n_cells (identical for all
        # placements); masked cells are not part of the package.
        sz = self.arch.chiplets[0].w * self.arch.chiplets[0].h
        n_cells = (self.R * self.C if self.allowed is None
                   else int(self.allowed.sum()))
        return float(sz * n_cells)

    # -- helpers ---------------------------------------------------------
    def _cell_allowed(self, r: int, c: int) -> bool:
        return self.allowed is None or bool(self.allowed[r, c])

    def _occupied_dirs(self, types: np.ndarray, r: int, c: int) -> list[int]:
        """Rotations whose PHY faces an occupied neighbor cell."""
        out = []
        for rot, d in enumerate(_ROT_DIR):
            dr, dc = _DIR_DELTA[d]
            rr, cc = r + dr, c + dc
            if 0 <= rr < self.R and 0 <= cc < self.C and types[rr, cc] >= 0:
                out.append(rot)
        return out

    def _inside_dirs(self, r: int, c: int) -> list[int]:
        out = []
        for rot, d in enumerate(_ROT_DIR):
            dr, dc = _DIR_DELTA[d]
            rr, cc = r + dr, c + dc
            if 0 <= rr < self.R and 0 <= cc < self.C \
                    and self._cell_allowed(rr, cc):
                out.append(rot)
        return out

    def _roll_rotation(self, types: np.ndarray, r: int, c: int,
                       rng: np.random.Generator) -> int:
        """Pick a rotation: PHY must face another chiplet, not the outside."""
        cands = self._occupied_dirs(types, r, c) or self._inside_dirs(r, c) \
            or [0, 1, 2, 3]
        return int(rng.choice(cands))

    def _fix_rotations(self, types: np.ndarray, rot: np.ndarray,
                       rng: np.random.Generator) -> None:
        """Re-roll rotations of single-PHY chiplets in-place."""
        for r in range(self.R):
            for c in range(self.C):
                k = types[r, c]
                if k >= 0 and self._rotatable.get(int(k), False):
                    rot[r, c] = self._roll_rotation(types, r, c, rng)
                else:
                    rot[r, c] = 0

    # -- the four representation functions (§IV) --------------------------
    def random(self, rng: np.random.Generator) -> Sol:
        cells = self.R * self.C
        flat = np.full(cells, -1, dtype=np.int8)
        kinds = [k for k, ids in self._kind_instances.items()
                 for _ in ids]
        cand = (np.arange(cells) if self.allowed is None
                else np.flatnonzero(self.allowed.reshape(-1)))
        pos = rng.choice(cand, size=len(kinds), replace=False)
        flat[pos] = np.array(kinds, dtype=np.int8)
        types = flat.reshape(self.R, self.C)
        rot = np.zeros_like(types)
        self._fix_rotations(types, rot, rng)
        return types, rot

    def mutate(self, sol: Sol, rng: np.random.Generator) -> Sol:
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
        """Swap two cells of *different* types (empty counts as a type)."""
        for _ in range(200):
            r1 = int(rng.integers(self.R))
            c1 = int(rng.integers(self.C))
            if neighbor:
                d = _ROT_DIR[int(rng.integers(4))]
                dr, dc = _DIR_DELTA[d]
                r2, c2 = r1 + dr, c1 + dc
                if not (0 <= r2 < self.R and 0 <= c2 < self.C):
                    continue
            else:
                r2 = int(rng.integers(self.R))
                c2 = int(rng.integers(self.C))
            if not (self._cell_allowed(r1, c1)
                    and self._cell_allowed(r2, c2)):
                continue
            if types[r1, c1] == types[r2, c2]:
                continue
            if types[r1, c1] < 0 and types[r2, c2] < 0:
                continue
            types[r1, c1], types[r2, c2] = types[r2, c2], types[r1, c1]
            rot[r1, c1], rot[r2, c2] = rot[r2, c2], rot[r1, c1]
            for (r, c) in ((r1, c1), (r2, c2)):
                k = types[r, c]
                if k >= 0 and self._rotatable.get(int(k), False):
                    rot[r, c] = self._roll_rotation(types, r, c, rng)
                else:
                    rot[r, c] = 0
            return

    def _rotate_one(self, types, rot, rng) -> None:
        cand = [(r, c) for r in range(self.R) for c in range(self.C)
                if types[r, c] >= 0
                and self._rotatable.get(int(types[r, c]), False)]
        if not cand:
            return
        r, c = cand[int(rng.integers(len(cand)))]
        rot[r, c] = self._roll_rotation(types, r, c, rng)

    def merge(self, a: Sol, b: Sol, rng: np.random.Generator) -> Sol:
        """§V-A merge: keep matching types/rotations, randomize the rest."""
        ta, ra_ = a
        tb, rb_ = b
        types = np.full_like(ta, -2)            # -2 = unresolved
        match = ta == tb
        types[match] = ta[match]
        # Count how many chiplets of each kind were carried over.
        remaining = {k: len(ids) for k, ids in self._kind_instances.items()}
        for k in remaining:
            remaining[k] -= int((types == k).sum())
        # Fill unresolved cells with leftover chiplets + empties.
        unresolved = np.argwhere(types == -2)
        fill = []
        for k, n in remaining.items():
            fill += [k] * n
        fill += [-1] * (len(unresolved) - len(fill))
        fill = np.array(fill, dtype=np.int8)
        rng.shuffle(fill)
        for (r, c), v in zip(unresolved, fill):
            types[r, c] = v
        rot = np.zeros_like(types)
        rot_match = match & (ra_ == rb_)
        rot[rot_match] = ra_[rot_match]
        # Re-roll rotations that were not carried over (or face emptiness).
        for r in range(self.R):
            for c in range(self.C):
                k = types[r, c]
                if k >= 0 and self._rotatable.get(int(k), False):
                    if not rot_match[r, c]:
                        rot[r, c] = self._roll_rotation(types, r, c, rng)
                else:
                    rot[r, c] = 0
        return types, rot

    # -- geometry / network ---------------------------------------------
    def _assign_instances(self, types: np.ndarray) -> np.ndarray:
        """Row-major scan assigns concrete chiplet instance ids to cells."""
        inst = np.full((self.R, self.C), -1, dtype=np.int64)
        counters = {k: 0 for k in self._kind_instances}
        for r in range(self.R):
            for c in range(self.C):
                k = int(types[r, c])
                if k < 0:
                    continue
                inst[r, c] = self._kind_instances[k][counters[k]]
                counters[k] += 1
        return inst

    def _phy_of(self, inst: int, types, rot, r: int, c: int,
                direction: str) -> int:
        """Global PHY index of chiplet ``inst`` facing ``direction`` or -1."""
        ch = self.arch.chiplets[inst]
        if ch.n_phys() == 4:
            # base phys order is n, e, s, w (see homogeneous_chiplet)
            local = "nesw".index(direction)
            return int(self._phy_base[inst]) + local
        if _ROT_DIR[int(rot[r, c])] == direction:
            return int(self._phy_base[inst])
        return -1

    def links_of(self, sol: Sol) -> tuple[list[tuple[int, int]], np.ndarray]:
        """§V-A get_network: connect opposing PHYs of adjacent chiplets."""
        types, rot = sol
        inst = self._assign_instances(types)
        links: list[tuple[int, int]] = []
        for r in range(self.R):
            for c in range(self.C):
                if types[r, c] < 0:
                    continue
                for d in ("n", "e"):       # scan each adjacency once
                    dr, dc = _DIR_DELTA[d]
                    rr, cc = r + dr, c + dc
                    if not (0 <= rr < self.R and 0 <= cc < self.C):
                        continue
                    if types[rr, cc] < 0:
                        continue
                    p = self._phy_of(int(inst[r, c]), types, rot, r, c, d)
                    q = self._phy_of(int(inst[rr, cc]), types, rot, rr, cc,
                                     _OPP[d])
                    if p >= 0 and q >= 0:
                        links.append((p, q))
        return links, inst

    def is_connected(self, sol: Sol) -> bool:
        types, _ = sol
        links, inst = self.links_of(sol)
        n = len(self.arch.chiplets)
        uf = _UnionFind(n)
        owner = self._owner_of_phys(inst)
        for p, q in links:
            uf.union(int(owner[p]), int(owner[q]))
        cells = inst[inst >= 0]
        roots = {uf.find(int(i)) for i in cells}
        return len(roots) == 1

    def _owner_of_phys(self, inst: np.ndarray) -> np.ndarray:
        Vp = int(self._phy_base[-1])
        owner = np.zeros(Vp, dtype=np.int32)
        for i, ch in enumerate(self.arch.chiplets):
            owner[self._phy_base[i]:self._phy_base[i + 1]] = i
        return owner

    def geometry(self, sol: Sol) -> PlacedPhys:
        types, rot = sol
        inst = self._assign_instances(types)
        Vp = int(self._phy_base[-1])
        pos = np.zeros((Vp, 2), dtype=np.float32)
        sz = self.arch.chiplets[0].w
        for r in range(self.R):
            for c in range(self.C):
                i = int(inst[r, c])
                if i < 0:
                    continue
                ch = self.arch.chiplets[i].rotated(int(rot[r, c])
                                                   if self.arch.chiplets[i]
                                                   .n_phys() == 1 else 0)
                ox, oy = c * sz, r * sz
                for li, (x, y) in enumerate(ch.phys):
                    pos[self._phy_base[i] + li] = (ox + x, oy + y)
        owner = self._owner_of_phys(inst)
        relay = np.array([ch.relay for ch in self.arch.chiplets])
        kinds = np.array(self.arch.kinds(), dtype=np.int8)
        return PlacedPhys(pos=pos, owner=owner, relay=relay, kinds=kinds,
                          area=self.area)

    def score_graph(self, sol: Sol) -> ScoreGraph:
        links, _ = self.links_of(sol)
        geo = self.geometry(sol)
        return build_score_graph(self.arch, geo, links, self.e_max,
                                 self.is_connected(sol))


    def batch_ops(self):
        """The device-resident batched operators (``HomogBatch``) are not
        ported yet."""
        raise NotImplementedError(
            "HomogBatch (batched device operators) is not ported yet: "
            "ROADMAP queue 1 item 7")
