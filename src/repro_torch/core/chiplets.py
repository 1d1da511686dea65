"""Chiplet, PHY and architecture specifications (paper §IV, Tables II-IV).

Every chiplet is categorized as compute / memory / IO (paper assumption 1).
A chiplet knows its dimensions [mm], its PHY positions (paper assumption 2),
and whether it can relay traffic (assumption 5).  PHYs share one protocol and
data width (assumptions 3-4) so any two PHYs can be joined by a D2D link.

Rotation semantics (§VI-A, Fig. 8): a chiplet is *rotation-invariant* /
*rotation-hybrid* / *rotation-sensitive* depending on whether shape and PHY
locations change under rotation; we compute the class from the geometry and
expose only non-isomorphic rotations to the optimizer.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Sequence

COMPUTE, MEMORY, IO = 0, 1, 2
TYPE_NAMES = ("compute", "memory", "io")
TRAFFIC_TYPES = ("c2c", "c2m", "c2i", "m2i")
# (src type, dst type) unordered chiplet-type pairs per traffic class; loads /
# latencies are evaluated over ordered pairs in both directions.
TRAFFIC_ENDPOINTS = {
    "c2c": (COMPUTE, COMPUTE),
    "c2m": (COMPUTE, MEMORY),
    "c2i": (COMPUTE, IO),
    "m2i": (MEMORY, IO),
}


@dataclass(frozen=True)
class Chiplet:
    """A chiplet type: rectangle (w, h) in mm with PHYs on its perimeter."""

    name: str
    kind: int                      # COMPUTE | MEMORY | IO
    w: float
    h: float
    phys: tuple[tuple[float, float], ...]  # (x, y) in chiplet-local mm
    relay: bool

    # ---- rotation geometry -------------------------------------------------
    def rotated(self, rot: int) -> "Chiplet":
        """Rotate by rot*90 degrees counter-clockwise about the origin corner.

        The rotated chiplet is re-anchored so its bounding box has its lower
        left corner at (0, 0) again.
        """
        rot = rot % 4
        if rot == 0:
            return self
        w, h, phys = self.w, self.h, self.phys
        for _ in range(rot):
            # (x, y) -> (-y, x), then shift by old h to re-anchor.
            phys = tuple((h - y, x) for (x, y) in phys)
            w, h = h, w
        return dataclasses.replace(self, w=w, h=h, phys=phys)

    def _canon(self) -> tuple:
        return (
            round(self.w, 6),
            round(self.h, 6),
            tuple(sorted((round(x, 6), round(y, 6)) for x, y in self.phys)),
        )

    def allowed_rotations(self) -> tuple[int, ...]:
        """Non-isomorphic rotations (Fig. 8 right).

        rotation-invariant -> (0,), rotation-hybrid (180deg symmetric) ->
        (0, 1), rotation-sensitive -> (0, 1, 2, 3).  Intermediate symmetry
        classes are handled generically by keeping one representative per
        distinct geometry.
        """
        seen: dict[tuple, int] = {}
        for r in range(4):
            key = self.rotated(r)._canon()
            seen.setdefault(key, r)
        return tuple(sorted(set(seen.values())))

    def n_phys(self) -> int:
        return len(self.phys)


def _mid_side_phys(w: float, h: float, sides: str) -> tuple[tuple[float, float], ...]:
    """PHYs centered on the requested sides; 'n','e','s','w'."""
    out = []
    for s in sides:
        if s == "n":
            out.append((w / 2, h))
        elif s == "s":
            out.append((w / 2, 0.0))
        elif s == "e":
            out.append((w, h / 2))
        elif s == "w":
            out.append((0.0, h / 2))
        else:  # pragma: no cover - config error
            raise ValueError(s)
    return tuple(out)


@dataclass(frozen=True)
class LatencyParams:
    """Cycle latencies (Table II): PHY, link, relay."""

    l_phy: float = 12.0
    l_link: float = 1.0
    l_relay: float = 10.0

    def d2d_cost(self) -> float:
        # One D2D hop crosses the sending PHY, the link and the receiving PHY.
        return 2.0 * self.l_phy + self.l_link


@dataclass(frozen=True)
class ArchSpec:
    """An architecture to be optimized (Table II bottom)."""

    name: str
    chiplets: tuple[Chiplet, ...]        # one entry per chiplet *instance*
    latency: LatencyParams
    max_link_mm: float = 3.0
    distance: str = "euclidean"          # or "manhattan"
    # Cost-function weights (paper §V-B): area & C2M/M2I get 2, C2C/C2I 0.1.
    # DEPRECATED alias: these fields only seed the *default* objective
    # (objective.Objective.from_arch / default_objective()); prefer an
    # explicit ``Objective`` (ExperimentConfig.objective or
    # Evaluator(objective=...)) for custom mixes and extra cost terms.
    w_lat: tuple[float, float, float, float] = (0.1, 2.0, 0.1, 2.0)
    w_thr: tuple[float, float, float, float] = (0.1, 2.0, 0.1, 2.0)
    w_area: float = 2.0

    def default_objective(self):
        """The deprecated ``w_*`` weight fields as a typed
        :class:`repro_torch.core.objective.Objective` (the migration
        bridge)."""
        from .objective import Objective
        return Objective.from_arch(self)

    def counts(self) -> tuple[int, int, int]:
        c = sum(1 for x in self.chiplets if x.kind == COMPUTE)
        m = sum(1 for x in self.chiplets if x.kind == MEMORY)
        i = sum(1 for x in self.chiplets if x.kind == IO)
        return c, m, i

    def kinds(self) -> tuple[int, ...]:
        return tuple(x.kind for x in self.chiplets)

    def dist(self, a: tuple[float, float], b: tuple[float, float]) -> float:
        dx, dy = a[0] - b[0], a[1] - b[1]
        if self.distance == "manhattan":
            return abs(dx) + abs(dy)
        return math.hypot(dx, dy)


# ---------------------------------------------------------------------------
# Paper architectures.
#
# Homogeneous (§V-B): 3mm x 3mm chiplets.  Two chiplet configurations are
# evaluated (§VII): *baseline* = memory/IO chiplets have a single PHY and
# cannot relay; *placeit* = every chiplet has four PHYs and relay capability.
# Compute chiplets always have 4 PHYs + relay.
# ---------------------------------------------------------------------------

def homogeneous_chiplet(kind: int, config: str) -> Chiplet:
    name = TYPE_NAMES[kind]
    if kind == COMPUTE or config == "placeit":
        return Chiplet(name, kind, 3.0, 3.0, _mid_side_phys(3.0, 3.0, "nesw"),
                       relay=True)
    if config == "baseline":
        # Single PHY (south side by convention; rotation orients it).
        return Chiplet(name, kind, 3.0, 3.0, _mid_side_phys(3.0, 3.0, "s"),
                       relay=False)
    raise ValueError(config)


def homogeneous_arch(n_compute: int, n_memory: int, n_io: int,
                     config: str = "baseline",
                     latency: LatencyParams = LatencyParams()) -> ArchSpec:
    chips = (
        tuple(homogeneous_chiplet(COMPUTE, config) for _ in range(n_compute))
        + tuple(homogeneous_chiplet(MEMORY, config) for _ in range(n_memory))
        + tuple(homogeneous_chiplet(IO, config) for _ in range(n_io))
    )
    return ArchSpec(
        name=f"homog_{n_compute}c{n_memory}m{n_io}i_{config}",
        chiplets=chips, latency=latency,
    )


# Heterogeneous (§VI-B, Fig. 11).  Fig. 11 is an image we cannot read; the
# dimensions below are documented substitutes (DESIGN.md §3): compute 3x3 with
# 4 PHYs, memory 3x5 with 2 PHYs on one long side, IO 2x4 with 1 PHY.
def heterogeneous_chiplet(kind: int, config: str) -> Chiplet:
    if kind == COMPUTE:
        return Chiplet("compute", kind, 3.0, 3.0,
                       _mid_side_phys(3.0, 3.0, "nesw"), relay=True)
    if kind == MEMORY:
        if config == "placeit":
            return Chiplet("memory", kind, 3.0, 5.0,
                           _mid_side_phys(3.0, 5.0, "nesw"), relay=True)
        # two PHYs spread along the east (long) side
        return Chiplet("memory", kind, 3.0, 5.0,
                       ((3.0, 1.25), (3.0, 3.75)), relay=False)
    if kind == IO:
        if config == "placeit":
            return Chiplet("io", kind, 2.0, 4.0,
                           _mid_side_phys(2.0, 4.0, "nesw"), relay=True)
        return Chiplet("io", kind, 2.0, 4.0, _mid_side_phys(2.0, 4.0, "e"),
                       relay=False)
    raise ValueError(kind)


def heterogeneous_arch(n_compute: int, n_memory: int, n_io: int,
                       config: str = "baseline",
                       latency: LatencyParams = LatencyParams()) -> ArchSpec:
    chips = (
        tuple(heterogeneous_chiplet(COMPUTE, config) for _ in range(n_compute))
        + tuple(heterogeneous_chiplet(MEMORY, config) for _ in range(n_memory))
        + tuple(heterogeneous_chiplet(IO, config) for _ in range(n_io))
    )
    return ArchSpec(
        name=f"hetero_{n_compute}c{n_memory}m{n_io}i_{config}",
        chiplets=chips, latency=latency, max_link_mm=3.0, distance="euclidean",
    )


def paper_arch(which: str, config: str = "baseline") -> ArchSpec:
    """The paper's four experiment architectures (§V-B, §VI-B)."""
    if which == "homog32":
        return homogeneous_arch(32, 4, 4, config)
    if which == "homog64":
        return homogeneous_arch(64, 8, 8, config)
    if which == "hetero32":
        return heterogeneous_arch(32, 4, 4, config)
    if which == "hetero64":
        return heterogeneous_arch(64, 8, 8, config)
    raise ValueError(which)


# 100+-chiplet homogeneous families (the HexaMesh regime, PAPERS.md):
# (n_compute, n_memory, n_io).  Compute:memory:io stays ~10.5:1:1 like the
# paper's homog arches; hex127 is a centered-hexagonal arrangement (side 7
# -> 127 cells) placed on a masked square grid.
LARGE_HOMOG = {
    "homog100": (84, 8, 8),
    "homog144": (120, 12, 12),
    "homog256": (224, 16, 16),
    "hex127": (107, 10, 10),
}


def large_arch(which: str, config: str = "baseline") -> ArchSpec:
    """100+-chiplet homogeneous architectures beyond the paper's four."""
    try:
        nc, nm, ni = LARGE_HOMOG[which]
    except KeyError:
        raise ValueError(which) from None
    return homogeneous_arch(nc, nm, ni, config)


# 3D / hierarchical families: chiplet counts per family name —
# (n_compute, n_memory, n_io), homogeneous 3mm chiplets.  Their grids and
# placement representation live in ``repro_torch.arch3d``.
# Counts fill the grids exactly (32 = 4x4x2, 64 = 4x4x4) while keeping
# roughly the paper's compute-heavy shape.
ARCH3D = {
    "stack3d32": (24, 4, 4),
    "stack3d64": (52, 6, 6),
    "gw3d64": (52, 6, 6),
    "torus3d32": (24, 4, 4),
    "express3d32": (24, 4, 4),
}


def arch3d_arch(which: str, config: str = "baseline") -> ArchSpec:
    """A 3D/hierarchical family's ArchSpec (homogeneous chiplet mix; the
    3D structure lives in the representation, not the chiplet set)."""
    try:
        nc, nm, ni = ARCH3D[which]
    except KeyError:
        raise ValueError(which) from None
    return homogeneous_arch(nc, nm, ni, config)


def resolve_arch(which: str, config: str = "baseline") -> ArchSpec:
    """Any named architecture: the paper's four, a LARGE_HOMOG family, or
    a 3D/hierarchical ARCH3D family."""
    if which in LARGE_HOMOG:
        return large_arch(which, config)
    if which in ARCH3D:
        return arch3d_arch(which, config)
    return paper_arch(which, config)
