"""Heterogeneous placement representation (paper §VI-A, Figs. 7-10).

The optimization algorithms do not operate on chiplet coordinates.  They
operate on the *(order, rotations)* pair that is fed to a deterministic
corner-placement algorithm; every such pair yields an overlap-free placement.

Isomorphism avoidance (Fig. 8):
* the order is a sequence of chiplet *types*, not IDs (two different orders
  by ID can produce the same placement; orders by type cannot);
* rotations are restricted per type to the non-isomorphic set computed from
  the chiplet geometry (rotation-invariant -> {0}, rotation-hybrid ->
  {0, 90}, rotation-sensitive -> all four).

Corner placement (Fig. 7): chiplets are placed one at a time.  Candidate
anchors are the L-corners formed by already-placed rectangles (bottom-left
corner-point set); the anchor minimizing the side of the minimum enclosing
*square* wins (step 3).  Overlap created by the greedy choice is resolved by
the paper's step-4 rule: overlap to the right pushes the chiplet up; overlap
above pushes it right.

The port of ``repro.core.placement_hetero``: the host representation and
corner placement are numpy, as there; the batched operators
(:class:`HeteroBatch`) are tensor ops on a device, drawing from a
``torch.Generator``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .chiplets import COMPUTE, IO, MEMORY, ArchSpec, Chiplet
from .placement_homog import first_true, onehot, permute_rows, uniform_pick
from .proxies import Layout, resolve_device
from .topology import (PlacedPhys, ScoreGraph, build_score_graph,
                       infer_links_mst)

Sol = tuple[np.ndarray, np.ndarray]  # (order [N] kinds int8, rots [N] int8)


def sol_key(sol: Sol) -> bytes:
    return sol[0].tobytes() + sol[1].tobytes()


def _overlap(x, y, w, h, rects) -> int:
    """Index of the first placed rect overlapping (x,y,w,h), or -1."""
    if len(rects) == 0:
        return -1
    rx, ry, rw, rh = rects[:, 0], rects[:, 1], rects[:, 2], rects[:, 3]
    ov = (x < rx + rw - 1e-9) & (rx < x + w - 1e-9) & \
         (y < ry + rh - 1e-9) & (ry < y + h - 1e-9)
    idx = np.nonzero(ov)[0]
    return int(idx[0]) if len(idx) else -1


def corner_place(dims: list[tuple[float, float]]
                 ) -> np.ndarray:
    """Place rectangles in order; returns [N, 2] lower-left positions.

    Deterministic; never produces overlaps.  See module docstring.
    """
    n = len(dims)
    out = np.zeros((n, 2), dtype=np.float64)
    rects = np.zeros((0, 4), dtype=np.float64)
    for i, (w, h) in enumerate(dims):
        if i == 0:
            out[i] = (0.0, 0.0)
            rects = np.array([[0.0, 0.0, w, h]])
            continue
        # Candidate anchors: right-of and top-of corners of placed rects.
        cands = [(0.0, 0.0)]
        for (rx, ry, rw, rh) in rects:
            cands.append((rx + rw, ry))
            cands.append((rx, ry + rh))
        best = None
        cur_w = float((rects[:, 0] + rects[:, 2]).max())
        cur_h = float((rects[:, 1] + rects[:, 3]).max())
        for (cx, cy) in cands:
            x, y = cx, cy
            ok = False
            for _ in range(4 * n):          # bounded resolution loop
                j = _overlap(x, y, w, h, rects)
                if j < 0:
                    ok = True
                    break
                rx, ry, rw, rh = rects[j]
                # Step 4, from the overlap geometry: a blocking rect whose
                # bottom edge lies strictly above the candidate's bottom
                # overlaps from *above* -> move right past it; otherwise the
                # rect reaches the candidate's level, i.e. overlaps to the
                # *right* -> move up on top of it.  Both moves strictly
                # increase x or y, so the loop terminates.
                if ry > y + 1e-9:
                    x = rx + rw
                else:
                    y = ry + rh
            if not ok:
                continue
            side = max(max(cur_w, x + w), max(cur_h, y + h))
            key = (side, x + y, y, x)
            if best is None or key < best[0]:
                best = (key, x, y)
        assert best is not None
        _, x, y = best
        out[i] = (x, y)
        rects = np.concatenate([rects, [[x, y, w, h]]])
    return out


def corner_place_batch(dims: np.ndarray) -> np.ndarray:
    """Vectorized :func:`corner_place` across a population.

    ``dims`` is [B, N, 2] (w, h) per chiplet in placement order; returns
    [B, N, 2] lower-left positions.  The algorithm is inherently sequential
    per individual — each chiplet's candidate anchors depend on all earlier
    placements — so this runs the same N placement steps, but array-at-a-time
    across the whole population.  Bit-for-bit identical to the scalar path:
    the overlap-resolution moves are the same, and although candidates are
    enumerated in a different order, equal selection keys imply equal
    positions, so the lexicographic minimum is order-independent.
    """
    B, N, _ = dims.shape
    out = np.zeros((B, N, 2), dtype=np.float64)
    rects = np.zeros((B, N, 4), dtype=np.float64)
    rects[:, 0, 2:] = dims[:, 0]
    b_idx = np.arange(B)
    for i in range(1, N):
        wv = dims[:, i, 0][:, None]                      # [B, 1]
        hv = dims[:, i, 1][:, None]
        placed = rects[:, :i]                            # [B, i, 4]
        right = np.stack([placed[:, :, 0] + placed[:, :, 2],
                          placed[:, :, 1]], axis=-1)
        top = np.stack([placed[:, :, 0],
                        placed[:, :, 1] + placed[:, :, 3]], axis=-1)
        cands = np.concatenate(
            [np.zeros((B, 1, 2)), right, top], axis=1)   # [B, K, 2]
        x = cands[:, :, 0].copy()
        y = cands[:, :, 1].copy()
        ok = np.zeros(x.shape, dtype=bool)
        rx = placed[:, None, :, 0]
        ry = placed[:, None, :, 1]
        rw = placed[:, None, :, 2]
        rh = placed[:, None, :, 3]
        for _ in range(4 * N):                           # bounded resolution
            ov = ((x[:, :, None] < rx + rw - 1e-9)
                  & (rx < x[:, :, None] + wv[:, :, None] - 1e-9)
                  & (y[:, :, None] < ry + rh - 1e-9)
                  & (ry < y[:, :, None] + hv[:, :, None] - 1e-9))
            any_ov = ov.any(-1)
            ok |= ~any_ov
            pending = any_ov & ~ok
            if not pending.any():
                break
            blk = placed[b_idx[:, None], ov.argmax(-1)]  # first overlap [B,K,4]
            move_right = blk[:, :, 1] > y + 1e-9         # blocker above anchor
            nx = np.where(move_right, blk[:, :, 0] + blk[:, :, 2], x)
            ny = np.where(move_right, y, blk[:, :, 1] + blk[:, :, 3])
            x = np.where(pending, nx, x)
            y = np.where(pending, ny, y)
        cur_w = (placed[:, :, 0] + placed[:, :, 2]).max(1)[:, None]
        cur_h = (placed[:, :, 1] + placed[:, :, 3]).max(1)[:, None]
        side = np.maximum(np.maximum(cur_w, x + wv), np.maximum(cur_h, y + hv))
        k0 = np.where(ok, side, np.inf)
        k1 = np.where(ok, x + y, np.inf)
        k2 = np.where(ok, y, np.inf)
        k3 = np.where(ok, x, np.inf)
        sel = np.lexsort((k3, k2, k1, k0))[:, 0]         # primary key: k0
        assert ok[b_idx, sel].all()
        xi, yi = x[b_idx, sel], y[b_idx, sel]
        out[:, i, 0], out[:, i, 1] = xi, yi
        rects[:, i] = np.stack([xi, yi, dims[:, i, 0], dims[:, i, 1]], axis=-1)
    return out


@dataclass
class HeteroRep:
    """Placement representation + operators for heterogeneous chiplet shapes."""

    arch: ArchSpec
    mutation_mode: str = "any-one"

    def __post_init__(self):
        self._kind_instances = {
            k: [i for i, ch in enumerate(self.arch.chiplets) if ch.kind == k]
            for k in (COMPUTE, MEMORY, IO)
        }
        n = len(self.arch.chiplets)
        self._phy_base = np.zeros(n + 1, dtype=np.int64)
        for i, ch in enumerate(self.arch.chiplets):
            self._phy_base[i + 1] = self._phy_base[i] + ch.n_phys()
        # One prototype chiplet per kind (instances of a kind are identical).
        self._proto: dict[int, Chiplet] = {
            k: self.arch.chiplets[ids[0]]
            for k, ids in self._kind_instances.items() if ids
        }
        self._allowed_rot = {k: ch.allowed_rotations()
                             for k, ch in self._proto.items()}

    @property
    def layout(self) -> Layout:
        return Layout(Vp=int(self._phy_base[-1]), kinds=self.arch.kinds())

    @property
    def e_max(self) -> int:
        return 2 * int(self._phy_base[-1])

    # -- representation functions ------------------------------------------
    def random(self, rng: np.random.Generator) -> Sol:
        order = np.array([k for k, ids in self._kind_instances.items()
                          for _ in ids], dtype=np.int8)
        rng.shuffle(order)
        rots = np.array([rng.choice(self._allowed_rot[int(k)])
                         for k in order], dtype=np.int8)
        return order, rots

    def mutate(self, sol: Sol, rng: np.random.Generator) -> Sol:
        order = sol[0].copy()
        rots = sol[1].copy()
        both = self.mutation_mode.endswith("both")
        do_swap = both or bool(rng.integers(2))
        do_rot = both or not do_swap
        if do_swap:
            for _ in range(100):
                i, j = rng.integers(len(order), size=2)
                if order[i] != order[j]:
                    order[i], order[j] = order[j], order[i]
                    rots[i], rots[j] = rots[j], rots[i]
                    for p in (i, j):
                        if rots[p] not in self._allowed_rot[int(order[p])]:
                            rots[p] = rng.choice(
                                self._allowed_rot[int(order[p])])
                    break
        if do_rot:
            cand = [i for i in range(len(order))
                    if len(self._allowed_rot[int(order[i])]) > 1]
            if cand:
                i = cand[int(rng.integers(len(cand)))]
                rots[i] = rng.choice(self._allowed_rot[int(order[i])])
        return order, rots

    def merge(self, a: Sol, b: Sol, rng: np.random.Generator) -> Sol:
        """Fig. 10: carry over matching types/rotations, randomize the rest."""
        oa, ra = a
        ob, rb = b
        n = len(oa)
        order = np.full(n, -1, dtype=np.int8)
        match = oa == ob
        order[match] = oa[match]
        remaining = {k: len(ids) for k, ids in self._kind_instances.items()}
        for k in remaining:
            remaining[k] -= int((order == k).sum())
        fill = [k for k, cnt in remaining.items() for _ in range(cnt)]
        fill = np.array(fill, dtype=np.int8)
        rng.shuffle(fill)
        order[order == -1] = fill
        rots = np.zeros(n, dtype=np.int8)
        rmatch = match & (ra == rb)
        rots[rmatch] = ra[rmatch]
        for i in range(n):
            if not rmatch[i] or rots[i] not in self._allowed_rot[int(order[i])]:
                rots[i] = rng.choice(self._allowed_rot[int(order[i])])
        return order, rots

    # -- geometry / network --------------------------------------------------
    def place(self, sol: Sol) -> tuple[np.ndarray, list[Chiplet], np.ndarray]:
        """Run the corner-placement algorithm.

        Returns (positions [N,2] in *order* order, rotated chiplets, instance
        ids per order position).
        """
        order, rots = sol
        chips = [self._proto[int(k)].rotated(int(r))
                 for k, r in zip(order, rots)]
        pos = corner_place([(c.w, c.h) for c in chips])
        counters = {k: 0 for k in self._kind_instances}
        inst = np.zeros(len(order), dtype=np.int64)
        for p, k in enumerate(order):
            inst[p] = self._kind_instances[int(k)][counters[int(k)]]
            counters[int(k)] += 1
        return pos, chips, inst

    def geometry(self, sol: Sol) -> PlacedPhys:
        pos, chips, inst = self.place(sol)
        Vp = int(self._phy_base[-1])
        ppos = np.zeros((Vp, 2), dtype=np.float32)
        owner = np.zeros(Vp, dtype=np.int32)
        for i, ch in enumerate(self.arch.chiplets):
            owner[self._phy_base[i]:self._phy_base[i + 1]] = i
        for p, ch in enumerate(chips):
            i = int(inst[p])
            for li, (x, y) in enumerate(ch.phys):
                ppos[self._phy_base[i] + li] = (pos[p, 0] + x, pos[p, 1] + y)
        # get_area: minimal enclosing rectangle (§VI-A).
        xs = np.array([pos[p, 0] + chips[p].w for p in range(len(chips))])
        ys = np.array([pos[p, 1] + chips[p].h for p in range(len(chips))])
        area = float(xs.max() * ys.max())
        relay = np.array([ch.relay for ch in self.arch.chiplets])
        kinds = np.array(self.arch.kinds(), dtype=np.int8)
        return PlacedPhys(pos=ppos, owner=owner, relay=relay, kinds=kinds,
                          area=area)

    def score_graph(self, sol: Sol) -> ScoreGraph:
        geo = self.geometry(sol)
        links, connected = infer_links_mst(self.arch, geo)
        return build_score_graph(self.arch, geo, links, self.e_max, connected)

    def is_connected(self, sol: Sol) -> bool:
        geo = self.geometry(sol)
        _, connected = infer_links_mst(self.arch, geo)
        return connected

    def batch_ops(self, device=None) -> "HeteroBatch":
        """Cached batched operators for this arch on ``device`` (default:
        the card, see ``proxies.resolve_device``)."""
        dev = resolve_device(device)
        cache = self.__dict__.setdefault("_batch_ops", {})
        if str(dev) not in cache:
            cache[str(dev)] = HeteroBatch(self, dev)
        return cache[str(dev)]


# ---------------------------------------------------------------------------
# Device-resident batched operators.
#
# Mirrors placement_homog.HomogBatch for the heterogeneous representation:
# the host operators above generate/mutate/merge one (order, rots) pair at a
# time; HeteroBatch makes the same decisions as tensor ops over stacked
# [B, N] int8 tensors, drawing from a ``torch.Generator`` on their device.
# Equivalence with the host operators is *distributional* — every random
# choice is uniform over the same candidate set — not draw for draw.  The
# corner placement itself is inherently sequential per individual and stays
# host-side, but vectorized across the population (geometry_batch /
# corner_place_batch).
# ---------------------------------------------------------------------------

_KINDS3 = (COMPUTE, MEMORY, IO)
_SWAP_TRIES = 128     # host caps at 100 sequential tries; pre-drawn here
_ROT_DRAW = 12        # lcm of possible |allowed_rotations| in {1, 2, 3, 4, 6}


class HeteroBatch:
    """Vectorized ``random/mutate/merge`` + batch geometry for one arch."""

    def __init__(self, rep: HeteroRep, device):
        self.rep = rep
        self.device = dev = torch.device(device)
        self.N = len(rep.arch.chiplets)
        self.Vp = int(rep._phy_base[-1])
        fill = [k for k, ids in rep._kind_instances.items() for _ in ids]
        self._kinds_fill = torch.as_tensor(np.array(fill, dtype=np.int8),
                                           device=dev)
        self._counts = [len(rep._kind_instances.get(k, ())) for k in _KINDS3]
        # Per-kind non-isomorphic rotation sets (Fig. 8), as padded tables.
        rot_table = np.zeros((3, 4), np.int8)
        rot_count = np.ones(3, np.int64)
        allowed = np.zeros((3, 4), bool)
        for k, rl in rep._allowed_rot.items():
            rot_table[k, :len(rl)] = rl
            rot_count[k] = len(rl)
            allowed[k, list(rl)] = True
        self._rot_table = torch.as_tensor(rot_table, device=dev)
        self._rot_count = torch.as_tensor(rot_count, device=dev)
        self._allowed_mask = torch.as_tensor(allowed, device=dev)
        self._multi_rot = torch.as_tensor(rot_count > 1, device=dev)
        # Rotated geometry tables (host-side, float64 like corner_place).
        self._pmax = max(ch.n_phys() for ch in rep.arch.chiplets)
        self._dims_table = np.zeros((3, 4, 2), np.float64)
        self._phys_table = np.zeros((3, 4, self._pmax, 2), np.float64)
        self._nphys_kind = np.zeros(3, np.int64)
        for k, proto in rep._proto.items():
            self._nphys_kind[k] = proto.n_phys()
            for r in range(4):
                ch = proto.rotated(r)
                self._dims_table[k, r] = (ch.w, ch.h)
                self._phys_table[k, r, :len(ch.phys)] = ch.phys

    # -- rotation draws ------------------------------------------------------
    def _uniform_rot(self, gen, kind: torch.Tensor) -> torch.Tensor:
        """Uniform draw from each position's allowed-rotation set.  Exact:
        the draw range is a multiple of every possible set size."""
        draws = torch.randint(0, _ROT_DRAW, kind.shape, generator=gen,
                              device=self.device)
        return self._rot_table[kind, draws % self._rot_count[kind]]

    # -- the representation functions, batched -------------------------------
    def random_batch(self, gen: torch.Generator, n: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """n independent uniform (order, rots): a random permutation of the
        chiplet-kind multiset, rotations uniform over each kind's set."""
        order = permute_rows(gen, self._kinds_fill, n)
        return order, self._uniform_rot(gen, order.long())

    def mutate_batch(self, gen: torch.Generator, order, rots
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched ``mutate``: per individual either a swap of two
        differing-type positions or a re-roll of one multi-rotation chiplet
        (or both, per ``mutation_mode``), host first-valid-try semantics."""
        B, N, dev = order.shape[0], self.N, self.device
        if self.rep.mutation_mode.endswith("both"):
            do_swap = torch.ones(B, dtype=torch.bool, device=dev)
            do_rot = do_swap
        else:
            do_swap = torch.rand(B, generator=gen, device=dev) < 0.5
            do_rot = ~do_swap
        # Pre-drawn swap tries; the first valid one is the host's accepted
        # draw (identical first-success distribution).
        i = torch.randint(0, N, (B, _SWAP_TRIES), generator=gen, device=dev)
        j = torch.randint(0, N, (B, _SWAP_TRIES), generator=gen, device=dev)
        valid = order.gather(1, i) != order.gather(1, j)
        first = first_true(valid)[:, None]
        do_it = do_swap & valid.any(1)
        s1 = torch.where(do_it, i.gather(1, first)[:, 0], 0)
        s2 = torch.where(do_it, j.gather(1, first)[:, 0], 0)  # no-op swap
        b = torch.arange(B, device=dev)
        order2, rots2 = order.clone(), rots.clone()
        for flat in (order2, rots2):
            v1, v2 = flat[b, s1], flat[b, s2]
            flat[b, s1] = v2
            flat[b, s2] = v1
        kind = order2.long()
        # Host fixes swapped rotations only when illegal for the new kind.
        swapped = onehot(s1, do_it, N) | onehot(s2, do_it, N)
        legal = self._allowed_mask[kind, rots2.long()]
        rots2 = torch.where(swapped & ~legal, self._uniform_rot(gen, kind),
                            rots2)
        # Rotation move: uniform pick among multi-rotation positions.
        multi = self._multi_rot[kind]
        pick = uniform_pick(gen, multi)
        upd = onehot(pick, do_rot & multi.any(1), N)
        rots2 = torch.where(upd, self._uniform_rot(gen, kind), rots2)
        return order2, rots2

    def merge_batch(self, gen: torch.Generator, oa, ra, ob, rb
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched Fig. 10 merge: carry agreeing types, distribute leftover
        chiplets uniformly over disagreeing positions (random-rank fill ==
        host's shuffled fill), carry rotations only where both agree."""
        B = oa.shape[0]
        match = oa == ob
        carried = torch.where(match, oa, -2)
        rem = [self._counts[k] - (carried == k).sum(1) for k in range(3)]
        prio = torch.rand((B, self.N), generator=gen, device=self.device)
        prio = torch.where(match, 2.0, prio)   # matched positions rank last
        rank = prio.argsort(dim=1, stable=True).argsort(1)
        c0 = rem[0][:, None]
        c1 = c0 + rem[1][:, None]
        fill = torch.where(rank < c0, COMPUTE,
                           torch.where(rank < c1, MEMORY, IO))
        order = torch.where(match, oa, fill.to(oa.dtype))
        rmatch = match & (ra == rb)
        rots = torch.where(rmatch, ra,
                           self._uniform_rot(gen, order.long()))
        return order, rots

    # -- batch geometry (host-side numpy; sequential only over N) ------------
    def geometry_batch(self, order: np.ndarray, rots: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Stacked [B, N] (order, rots) -> (PHY positions [B, Vp, 2] float32,
        areas [B] float32).  Bit-for-bit equal to ``HeteroRep.geometry`` per
        individual (same corner placement, same float32 rounding)."""
        order = np.asarray(order, dtype=np.int64)
        rots = np.asarray(rots, dtype=np.int64)
        B, N = order.shape
        dims = self._dims_table[order, rots]                 # [B, N, 2]
        pos = corner_place_batch(dims)
        inst = np.zeros((B, N), np.int64)
        for k, ids in self.rep._kind_instances.items():
            if not ids:
                continue
            mk = order == k
            rank = np.cumsum(mk, axis=1) - 1
            ids_a = np.asarray(ids)
            inst = np.where(mk, ids_a[np.clip(rank, 0, len(ids_a) - 1)], inst)
        offs = self._phys_table[order, rots]                 # [B, N, P, 2]
        cnt = self._nphys_kind[order]                        # [B, N]
        base = self.rep._phy_base[:-1][inst]                 # [B, N]
        li = np.arange(self._pmax)
        gi = base[:, :, None] + li[None, None, :]
        live = li[None, None, :] < cnt[:, :, None]
        coords = (pos[:, :, None, :] + offs).astype(np.float32)
        ppos = np.zeros((B, self.Vp, 2), np.float32)
        b_idx = np.broadcast_to(np.arange(B)[:, None, None], gi.shape)
        ppos[b_idx[live], gi[live]] = coords[live]
        area = ((pos[:, :, 0] + dims[:, :, 0]).max(axis=1)
                * (pos[:, :, 1] + dims[:, :, 1]).max(axis=1))
        return ppos, area.astype(np.float32)
