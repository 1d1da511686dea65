"""Nested dicts of tensors: the layers' caches.

A cache is a dict whose values are tensors or, for a griffin super-block,
dicts of the same kind (``{"s0": {"conv", "h"}, ..., "s2": {"k", "v"}}``).
These three functions stand in for the reference's ``jax.tree.map`` over
such caches.
"""
from __future__ import annotations

from collections.abc import Callable

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same keys), as a tree of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_stack(trees: list):
    """Trees of the same keys -> one tree, each leaf stacked on a new
    leading axis."""
    return tree_map(lambda *ts: torch.stack(ts), *trees)


def tree_index(tree, i: int):
    """Slice i of every leaf's leading axis (views, so writes into them
    land in ``tree``)."""
    return tree_map(lambda t: t[i], tree)
