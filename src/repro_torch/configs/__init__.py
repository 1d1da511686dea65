"""Assigned-architecture configs (one module per arch) + registry."""
from .registry import (ARCHS, SHAPES, all_cells, cache_specs,
                       eligible_shapes, get_config, input_specs)

__all__ = ["ARCHS", "SHAPES", "all_cells", "cache_specs", "eligible_shapes",
           "get_config", "input_specs"]
