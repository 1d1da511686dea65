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
import torch

from .chiplets import COMPUTE, IO, MEMORY, ArchSpec
from .proxies import Layout, resolve_device
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

    def batch_ops(self, device=None) -> "HomogBatch":
        """Cached batched operators for this grid on ``device`` (default:
        the card, see ``proxies.resolve_device``)."""
        dev = resolve_device(device)
        cache = self.__dict__.setdefault("_batch_ops", {})
        if str(dev) not in cache:
            cache[str(dev)] = HomogBatch(self, dev)
        return cache[str(dev)]


# ---------------------------------------------------------------------------
# Device-resident batched operators.
#
# The host operators above generate/mutate/merge one placement at a time with
# a ``np.random.Generator``; at HexaMesh scale the per-individual Python loop
# (plus the retry-until-connected loop around it) dominates wall time.
# ``HomogBatch`` mirrors the same decision points as tensor ops over stacked
# [B, R, C] ``(types, rot)`` int8 tensors, drawing from a
# ``torch.Generator`` on the tensors' device, so a whole GA generation / SA
# chain-block is produced in a few batched ops (see
# ``optimize.DevicePipeline``).  Equivalence with the host operators is
# *distributional* — every random choice is uniform over the same candidate
# set — not draw for draw.
# ---------------------------------------------------------------------------

_KINDS = (COMPUTE, MEMORY, IO)
_SWAP_TRIES = 128     # host caps at 200 sequential tries; pre-drawn here


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] bool -> [B] index of the first True of each row (0 for a row
    with none, as ``argmax`` gives), by an explicit min-index reduction."""
    T = mask.shape[1]
    idx = torch.arange(T, device=mask.device)
    return torch.where(mask, idx, T).amin(1) % T


def uniform_pick(gen: torch.Generator, cand: torch.Tensor) -> torch.Tensor:
    """[..., K] bool -> [...] index drawn uniformly among the True entries
    (the argmax of i.i.d. uniforms, as the argmax of Gumbel noise is; any
    index for a row with none)."""
    u = torch.rand(cand.shape, generator=gen, device=cand.device)
    return torch.where(cand, u, -1.0).argmax(-1)


def permute_rows(gen: torch.Generator, fill: torch.Tensor,
                 n: int) -> torch.Tensor:
    """[n, K] independent uniform permutations of ``fill`` [K] (each row
    an argsort of float64 uniforms)."""
    keys = torch.rand((n, fill.shape[0]), generator=gen, device=fill.device,
                      dtype=torch.float64)
    return fill[keys.argsort(1)]


def onehot(idx: torch.Tensor, flag: torch.Tensor, width: int) -> torch.Tensor:
    """[B] indices and flags -> [B, width] bool rows with one True at
    ``idx`` where ``flag`` holds."""
    cols = torch.arange(width, device=idx.device)
    return (cols[None, :] == idx[:, None]) & flag[:, None]


class HomogBatch:
    """Vectorized ``random/mutate/merge`` over stacked homogeneous grids."""

    def __init__(self, rep: HomogRep, device):
        self.rep = rep
        self.device = dev = torch.device(device)
        self.R, self.C = rep.R, rep.C
        self.cells = rep.R * rep.C
        allowed = (np.ones((self.R, self.C), bool) if rep.allowed is None
                   else rep.allowed)
        self._masked = rep.allowed is not None
        self._allowed_flat = torch.as_tensor(allowed.reshape(-1), device=dev)
        self._allowed_idx = torch.as_tensor(
            np.flatnonzero(allowed.reshape(-1)), device=dev)
        n_allowed = int(allowed.sum())
        fill = [k for k, ids in rep._kind_instances.items() for _ in ids]
        fill += [-1] * (n_allowed - len(fill))
        self._kinds_fill = torch.as_tensor(np.array(fill, dtype=np.int8),
                                           device=dev)
        self._counts = [len(rep._kind_instances.get(k, ())) for k in _KINDS]
        rotatable = np.array([bool(rep._rotatable.get(k, False))
                              for k in _KINDS])
        self._rotatable_kind = torch.as_tensor(rotatable, device=dev)
        self._any_rotatable = bool(rotatable.any())
        inside = np.zeros((self.R, self.C, 4), bool)
        for rot_i, d in enumerate(_ROT_DIR):
            dr, dc = _DIR_DELTA[d]
            for r in range(self.R):
                for c in range(self.C):
                    rr, cc = r + dr, c + dc
                    inside[r, c, rot_i] = (0 <= rr < self.R
                                           and 0 <= cc < self.C
                                           and allowed[rr, cc])
        self._inside = torch.as_tensor(inside, device=dev)
        self._dr = torch.tensor([_DIR_DELTA[d][0] for d in _ROT_DIR],
                                device=dev)
        self._dc = torch.tensor([_DIR_DELTA[d][1] for d in _ROT_DIR],
                                device=dev)

    # -- rotation re-roll (vectorized ``_fix_rotations``) -------------------
    def _neighbor_occ(self, occ: torch.Tensor) -> torch.Tensor:
        """[B, R, C] occupancy -> [B, R, C, 4] per-rotation neighbor
        occupancy in ``_ROT_DIR`` order (out-of-grid counts unoccupied)."""
        R, C = self.R, self.C
        po = torch.zeros(occ.shape[:-2] + (R + 2, C + 2), dtype=torch.bool,
                         device=occ.device)
        po[..., 1:-1, 1:-1] = occ
        return torch.stack(
            [po[..., 1 + dr:1 + dr + R, 1 + dc:1 + dc + C]
             for dr, dc in (_DIR_DELTA[d] for d in _ROT_DIR)], dim=-1)

    def _rotatable_cells(self, types: torch.Tensor) -> torch.Tensor:
        kind = types.clamp(0, 2).long()
        return (types >= 0) & self._rotatable_kind[kind]

    def _roll_rot_batch(self, gen, types, rot, update) -> torch.Tensor:
        """Re-roll rotations under ``update``: rotatable cells get a uniform
        pick from occupied-facing (else in-grid, else all) directions, all
        other updated cells get 0; cells outside ``update`` keep ``rot``."""
        nb = self._neighbor_occ(types >= 0)
        inside = self._inside.expand_as(nb)
        cand = torch.where(nb.any(-1, keepdim=True), nb,
                           torch.where(inside.any(-1, keepdim=True), inside,
                                       True))
        new = uniform_pick(gen, cand).to(torch.int8)
        rotatable = self._rotatable_cells(types)
        return torch.where(update & rotatable, new,
                           torch.where(update, 0, rot).to(torch.int8))

    # -- the four representation functions, batched -------------------------
    def random_batch(self, gen: torch.Generator, n: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """n independent uniform placements: a random permutation of the
        chiplet-kind multiset over the allowed cells, rotations re-rolled."""
        perm = permute_rows(gen, self._kinds_fill, n)
        if self._masked:
            flat = torch.full((n, self.cells), -1, dtype=torch.int8,
                              device=self.device)
            flat[:, self._allowed_idx] = perm
        else:
            flat = perm
        types = flat.reshape(n, self.R, self.C)
        rot = self._roll_rot_batch(gen, types, torch.zeros_like(types),
                                   torch.ones(types.shape, dtype=torch.bool,
                                              device=self.device))
        return types, rot

    def mutate_batch(self, gen: torch.Generator, types, rot
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched ``mutate``: per placement either a (neighbor-)swap of two
        differing cells or a re-roll of one rotatable chiplet (or both,
        per ``mutation_mode``), with the host's first-valid-try semantics."""
        B, dev = types.shape[0], self.device
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
        r1 = torch.randint(0, self.R, shape, generator=gen, device=dev)
        c1 = torch.randint(0, self.C, shape, generator=gen, device=dev)
        if neighbor:
            d = torch.randint(0, 4, shape, generator=gen, device=dev)
            r2 = r1 + self._dr[d]
            c2 = c1 + self._dc[d]
        else:
            r2 = torch.randint(0, self.R, shape, generator=gen, device=dev)
            c2 = torch.randint(0, self.C, shape, generator=gen, device=dev)
        inb = (r2 >= 0) & (r2 < self.R) & (c2 >= 0) & (c2 < self.C)
        i1 = r1 * self.C + c1
        i2 = r2.clamp(0, self.R - 1) * self.C + c2.clamp(0, self.C - 1)
        tflat = types.reshape(B, self.cells).clone()
        rflat = rot.reshape(B, self.cells).clone()
        t1 = tflat.gather(1, i1)
        t2 = tflat.gather(1, i2)
        valid = inb & (t1 != t2) & ~((t1 < 0) & (t2 < 0))
        if self._masked:
            valid &= self._allowed_flat[i1] & self._allowed_flat[i2]
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
        types2 = tflat.reshape(B, self.R, self.C)
        rot2 = self._roll_rot_batch(gen, types2,
                                    rflat.reshape(B, self.R, self.C),
                                    update.reshape(B, self.R, self.C))
        return types2, rot2

    def merge_batch(self, gen: torch.Generator, ta, ra, tb, rb
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched §V-A merge: keep agreeing cells, distribute the leftover
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
        types = types.reshape(B, self.R, self.C)
        rot_match = match & (ra == rb)
        rot0 = torch.where(rot_match, ra, 0).to(ra.dtype)
        update = ~(rot_match & self._rotatable_cells(types))
        return types, self._roll_rot_batch(gen, types, rot0, update)
