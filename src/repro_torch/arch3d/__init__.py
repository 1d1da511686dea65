"""3D & hierarchical arch families: TSV-aware stacked grids, gateway
backbones, and express/torus augmentation — pluggable through
``chiplets.resolve_arch`` / ``api.make_rep`` into the batched pipeline.

The port of ``repro.arch3d``: host operators and the host graph build in
numpy, the batched operators and graph build in torch on a device.
"""
from .families import FAMILIES3D, Family3DSpec, make_rep3d
from .placement import Homog3DBatch, Homog3DRep
from .topology import (TIER_BACKBONE, TIER_PLANAR, TIER_VERTICAL, AdjRecord,
                       Grid3DGraphBatch, default_tier_values, family_records,
                       grid3d_adjacency, score_graph3d_host)

__all__ = [
    "AdjRecord", "FAMILIES3D", "Family3DSpec", "Grid3DGraphBatch",
    "Homog3DBatch", "Homog3DRep", "TIER_BACKBONE", "TIER_PLANAR",
    "TIER_VERTICAL", "default_tier_values", "family_records",
    "grid3d_adjacency", "make_rep3d", "score_graph3d_host",
]
