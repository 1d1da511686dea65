"""2D-mesh baseline architectures (paper §VII, Fig. 13).

The baseline is the de-facto standard 2.5D layout used by Simba, Dojo and
others: a regular grid of compute-chiplets in the center with memory- and
IO-chiplets distributed along the perimeter.  Links form a 2D mesh between
adjacent compute-chiplets; each memory/IO chiplet connects to its adjacent
compute chiplet (via its single PHY in the *baseline* chiplet configuration,
via the facing PHY in the *placeit* configuration).

The baseline is expressed through the same ``ScoreGraph`` interface as
optimized placements, so it is scored by the identical proxy/cost pipeline —
apples-to-apples with PlaceIT outputs (§VII-B..E).
"""
from __future__ import annotations

import math

import numpy as np

from .chiplets import COMPUTE, IO, MEMORY, ArchSpec
from .proxies import Layout
from .topology import PlacedPhys, ScoreGraph, build_score_graph


def _grid_dims(n: int) -> tuple[int, int]:
    """Near-square grid (rows, cols) with rows*cols == n (or minimal cover)."""
    r = int(math.floor(math.sqrt(n)))
    while r > 1 and n % r != 0:
        r -= 1
    if r == 1:  # prime count: use minimal covering near-square grid
        r = int(math.floor(math.sqrt(n)))
        return r, int(math.ceil(n / r))
    return r, n // r


class MeshBaseline:
    """Constructs the §VII baseline placement + 2D-mesh ICI topology.

    Geometry: compute grid cells of pitch = max chiplet dimension; memory
    chiplets are split between the west and east flanks, IO chiplets between
    the south and north flanks, each facing (and linked to) the nearest
    compute chiplet.
    """

    def __init__(self, arch: ArchSpec):
        self.arch = arch
        kinds = arch.kinds()
        self.idx_c = [i for i, k in enumerate(kinds) if k == COMPUTE]
        self.idx_m = [i for i, k in enumerate(kinds) if k == MEMORY]
        self.idx_i = [i for i, k in enumerate(kinds) if k == IO]
        n = len(arch.chiplets)
        self._phy_base = np.zeros(n + 1, dtype=np.int64)
        for i, ch in enumerate(arch.chiplets):
            self._phy_base[i + 1] = self._phy_base[i] + ch.n_phys()
        self.R, self.C = _grid_dims(len(self.idx_c))
        # Grid pitch from the compute chiplets; flanks use their own widths
        # (a uniform max-chiplet pitch would inflate the baseline area and
        # flatter PlaceIT's area comparison, §VII-E).
        self.pitch = max(max(arch.chiplets[i].w, arch.chiplets[i].h)
                         for i in self.idx_c)
        self._flank_w = max((max(arch.chiplets[i].w, arch.chiplets[i].h)
                             for i in self.idx_m), default=0.0)
        self._flank_h = max((max(arch.chiplets[i].w, arch.chiplets[i].h)
                             for i in self.idx_i), default=0.0)

    # -- placement ---------------------------------------------------------
    def _positions(self) -> tuple[dict[int, tuple[float, float]], dict[int, int]]:
        """Chiplet-instance -> lower-left position [mm]; and -> rotation."""
        P = self.pitch
        pos: dict[int, tuple[float, float]] = {}
        rot: dict[int, int] = {}

        def center(inst: int, cx: float, cy: float):
            ch = self.arch.chiplets[inst]
            pos[inst] = (cx - ch.w / 2.0, cy - ch.h / 2.0)

        # Compute grid at the origin; flanks sit just outside it.
        for n_, inst in enumerate(self.idx_c):
            r, c = divmod(n_, self.C)
            center(inst, (c + 0.5) * P, (r + 0.5) * P)
            rot[inst] = 0
        # Memory chiplets: split W/E flank, evenly spread over rows.
        mw = self.idx_m[: (len(self.idx_m) + 1) // 2]
        me = self.idx_m[(len(self.idx_m) + 1) // 2:]
        for side, group in (("w", mw), ("e", me)):
            for j, inst in enumerate(group):
                row = int(round((j + 0.5) * self.R / max(len(group), 1) - 0.5))
                row = min(max(row, 0), self.R - 1)
                cx = (-self._flank_w / 2 if side == "w"
                      else self.C * P + self._flank_w / 2)
                center(inst, cx, (row + 0.5) * P)
                # Single-PHY chiplets: rotate so the PHY faces the grid.
                rot[inst] = self._facing_rotation(inst, side)
        # IO chiplets: split S/N flank, evenly spread over cols.
        is_ = self.idx_i[: (len(self.idx_i) + 1) // 2]
        in_ = self.idx_i[(len(self.idx_i) + 1) // 2:]
        for side, group in (("s", is_), ("n", in_)):
            for j, inst in enumerate(group):
                col = int(round((j + 0.5) * self.C / max(len(group), 1) - 0.5))
                col = min(max(col, 0), self.C - 1)
                cy = (-self._flank_h / 2 if side == "s"
                      else self.R * P + self._flank_h / 2)
                center(inst, (col + 0.5) * P, cy)
                rot[inst] = self._facing_rotation(inst, side)
        return pos, rot

    def _facing_rotation(self, inst: int, side: str) -> int:
        """Rotation that turns the chiplet's PHY centroid toward the grid."""
        ch = self.arch.chiplets[inst]
        if ch.n_phys() >= 4:
            return 0
        want = {"w": "e", "e": "w", "s": "n", "n": "s"}[side]
        best, best_score = 0, -1e9
        for r in ch.allowed_rotations() if ch.n_phys() == 1 else range(4):
            rc = ch.rotated(r)
            mx = float(np.mean([p[0] for p in rc.phys])) - rc.w / 2
            my = float(np.mean([p[1] for p in rc.phys])) - rc.h / 2
            score = {"e": mx, "w": -mx, "n": my, "s": -my}[want]
            if score > best_score:
                best, best_score = r, score
        return best

    # -- topology ------------------------------------------------------------
    def _closest_phys(self, rotated, pos, a: int, b: int) -> tuple[int, int, float]:
        """Globally-indexed closest PHY pair between chiplet instances a, b."""
        best = (-1, -1, 1e18)
        for ia, (xa, ya) in enumerate(rotated[a].phys):
            pa = (pos[a][0] + xa, pos[a][1] + ya)
            for ib, (xb, yb) in enumerate(rotated[b].phys):
                pb = (pos[b][0] + xb, pos[b][1] + yb)
                d = self.arch.dist(pa, pb)
                if d < best[2]:
                    best = (int(self._phy_base[a] + ia),
                            int(self._phy_base[b] + ib), d)
        return best

    def build(self) -> tuple[ScoreGraph, PlacedPhys, list[tuple[int, int]]]:
        pos, rot = self._positions()
        rotated = {i: self.arch.chiplets[i].rotated(rot[i])
                   for i in range(len(self.arch.chiplets))}
        # PHY geometry
        Vp = int(self._phy_base[-1])
        ppos = np.zeros((Vp, 2), dtype=np.float32)
        owner = np.zeros(Vp, dtype=np.int32)
        for i in range(len(self.arch.chiplets)):
            owner[self._phy_base[i]:self._phy_base[i + 1]] = i
            for li, (x, y) in enumerate(rotated[i].phys):
                ppos[self._phy_base[i] + li] = (pos[i][0] + x, pos[i][1] + y)
        xs = [pos[i][0] + rotated[i].w for i in pos]
        ys = [pos[i][1] + rotated[i].h for i in pos]
        x0 = [pos[i][0] for i in pos]
        y0 = [pos[i][1] for i in pos]
        area = float((max(xs) - min(x0)) * (max(ys) - min(y0)))
        geo = PlacedPhys(
            pos=ppos, owner=owner,
            relay=np.array([c.relay for c in self.arch.chiplets]),
            kinds=np.array(self.arch.kinds(), dtype=np.int8), area=area)
        # Mesh links between grid-adjacent compute chiplets (grid may have
        # empty tail slots when the compute count is prime).
        links: list[tuple[int, int]] = []
        flat = np.full(self.R * self.C, -1, dtype=np.int64)
        flat[:len(self.idx_c)] = self.idx_c
        grid = flat.reshape(self.R, self.C)
        for r in range(self.R):
            for c in range(self.C):
                if grid[r, c] < 0:
                    continue
                if c + 1 < self.C and grid[r, c + 1] >= 0:
                    p, q, _ = self._closest_phys(rotated, pos,
                                                 int(grid[r, c]),
                                                 int(grid[r, c + 1]))
                    links.append((p, q))
                if r + 1 < self.R and grid[r + 1, c] >= 0:
                    p, q, _ = self._closest_phys(rotated, pos,
                                                 int(grid[r, c]),
                                                 int(grid[r + 1, c]))
                    links.append((p, q))
        # Memory/IO chiplets: link to the nearest compute chiplet.
        for inst in self.idx_m + self.idx_i:
            best = None
            for cc in self.idx_c:
                p, q, d = self._closest_phys(rotated, pos, inst, cc)
                if best is None or d < best[2]:
                    best = (p, q, d)
            links.append((best[0], best[1]))
        e_max = 2 * max(len(links), Vp)
        g = build_score_graph(self.arch, geo, links, e_max, connected=True)
        return g, geo, links

    @property
    def layout(self) -> Layout:
        return Layout(Vp=int(self._phy_base[-1]), kinds=self.arch.kinds())


def baseline_graph(arch: ArchSpec) -> ScoreGraph:
    """Convenience: the baseline ScoreGraph for an architecture."""
    return MeshBaseline(arch).build()[0]
