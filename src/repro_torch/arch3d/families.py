"""Named 3D / hierarchical arch families and their representation factory.

Each family pairs a chiplet-count entry in ``core.chiplets.ARCH3D`` with
grid dimensions and a structural spec (stack vs gateway hierarchy, an
optional registered augmentation).  ``api.make_rep`` dispatches here for
any family name in ``ARCH3D``, so ``run_sweep`` / Pareto grids / the
design service open the 3D scenario space with an arch-name change only.

Tier semantics (``W_INTRA < W_BACKBONE < W_VERTICAL``): planar mesh links
are the paper's D2D cost, backbone / express links pay
``backbone_factor`` on the link latency, vertical TSVs pay
``tsv_slowdown`` — both runtime operands (see
``arch3d.topology.default_tier_values``).

The port of ``repro.arch3d.families``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.chiplets import ArchSpec

from .placement import Homog3DRep


@dataclass(frozen=True)
class Family3DSpec:
    """Structural spec of one 3D family (everything but chiplet counts)."""

    dims: tuple[int, int, int]                # (R, C, Z)
    kind: str = "stack"                       # stack | gateway
    cluster: tuple[int, int] | None = None
    augment: str = "none"                     # none | torus | express | ...
    augment_params: dict = field(default_factory=dict)
    tsv_slowdown: float = 4.0
    backbone_factor: float = 2.0


# Family registry.  Chiplet counts (core.chiplets.ARCH3D) fill the grids
# exactly — 32 chiplets on 2 layers of 4x4, 64 on 4 layers — keeping the
# paper's ~6:1:1 compute:memory:io shape, so a flat-vs-stacked comparison
# holds the chiplet set fixed and varies only the arrangement.
FAMILIES3D: dict[str, Family3DSpec] = {
    "stack3d32": Family3DSpec(dims=(4, 4, 2)),
    "stack3d64": Family3DSpec(dims=(4, 4, 4)),
    # Gateway hierarchies want the relay-capable "placeit" chiplet config:
    # under "baseline" a non-relay 1-PHY chiplet landing on a gateway cell
    # cuts its whole cluster off, so connected random placements are rare
    # (~2-3%) and generate_valid burns its retry budget.
    "gw3d64": Family3DSpec(dims=(4, 4, 4), kind="gateway", cluster=(2, 2)),
    "torus3d32": Family3DSpec(dims=(4, 4, 2), augment="torus"),
    "express3d32": Family3DSpec(dims=(4, 4, 2), augment="express"),
}


def make_rep3d(arch: ArchSpec, arch_name: str,
               mutation_mode: str = "neighbor-one") -> Homog3DRep:
    """Representation for a named 3D family (``FAMILIES3D`` keys)."""
    try:
        spec = FAMILIES3D[arch_name]
    except KeyError:
        raise ValueError(
            f"unknown 3D arch family {arch_name!r}; known: "
            f"{', '.join(sorted(FAMILIES3D))}") from None
    R, C, Z = spec.dims
    return Homog3DRep(arch, R=R, C=C, Z=Z, mutation_mode=mutation_mode,
                      kind=spec.kind, cluster=spec.cluster,
                      augment=spec.augment,
                      augment_params=dict(spec.augment_params),
                      tsv_slowdown=spec.tsv_slowdown,
                      backbone_factor=spec.backbone_factor)
