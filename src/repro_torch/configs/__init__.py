"""Assigned-architecture configs (one module per arch) + registry."""
from .registry import ARCHS, SHAPES, all_cells, eligible_shapes, get_config

__all__ = ["ARCHS", "SHAPES", "all_cells", "eligible_shapes", "get_config"]
