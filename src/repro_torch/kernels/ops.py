"""Public kernel API.  Dispatch is by the tensor's device: a CUDA tensor
goes to the hand-written kernel (which raises if it cannot build or
launch), a CPU tensor to the plain PyTorch version."""
from __future__ import annotations

from . import ref
from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .fw_counts import fw_counts
from .fw_counts_tiled import fw_counts_tiled
from .minplus import apsp, minplus
from .rglru_scan import rglru_scan
from .selective_scan import selective_scan

__all__ = ["fw_counts", "fw_counts_tiled", "minplus", "apsp",
           "flash_attention", "decode_attention", "selective_scan",
           "rglru_scan",
           "fw_impl_cuda", "fw_impl_ref", "fw_impl_tiled",
           "fw_takes_tiled", "dispatch_edges", "FW_TILED_FROM_V"]

# Scorer adapters: ``repro_torch.core.proxies.make_scorer(fw_impl=...)``
# takes a W -> (D, N) callable.  "fw-cuda" binds kernel 1 (the cluster
# kernel) for every V, "fw-ref" the plain version on whatever device W
# lies, "fw-tiled" (the default) the size dispatch below.
fw_impl_cuda = fw_counts
fw_impl_ref = ref.fw_counts_ref

# The smallest V at which fw_impl_tiled takes the blocked kernel.  On an
# NVIDIA H100 80GB HBM3 at 700 W, at B = 16 (ms, kernel 1 / blocked, by
# src/repro_torch/launch/kernel_compare.py --clusters): V = 40: 0.030 /
# 0.044; 56: 0.042 / 0.044; 64: 0.047 / 0.044; 80: 0.114 / 0.157; 96:
# 0.136 / 0.157; 112: 0.159 / 0.158; 130: 0.337 / 0.233; 216: 0.558 /
# 0.331; 480: 5.73 / 1.50.  Kernel 1 pays a cluster barrier a pivot and
# the blocked kernel a fused 64-pivot chain a tile row, so kernel 1 wins
# below about 112 but at V = 57 .. 64, where one 64 tile holds the whole
# graph (there it is up to 7 % slower; one threshold keeps the rule
# simple).  No architecture the port runs falls below it (homog32 V =
# 216 .. 240, homog64 432 .. 480, the 100+-chiplet families 552 .. 1536,
# the heterogeneous 220 .. 480, the 3D families 168 .. 384), so on every such
# workload the default backend takes the blocked kernel; kernel 1 serves
# smaller graphs and backend "fw-cuda".
FW_TILED_FROM_V = 112


def fw_takes_tiled(V: int) -> bool:
    """Whether ``fw_impl_tiled`` sends V to the blocked kernel."""
    return V >= FW_TILED_FROM_V


def dispatch_edges() -> tuple:
    """The V on each side of every dispatch threshold."""
    return (FW_TILED_FROM_V - 1, FW_TILED_FROM_V)


def fw_impl_tiled(W):
    """Size-dispatched FW, the default backend "fw-tiled": ``fw_counts``
    below ``FW_TILED_FROM_V``, ``fw_counts_tiled`` from there on
    (``fw_takes_tiled``).  Both are bit for bit equal to
    ``ref.fw_counts_ref``, so the dispatch point is invisible in
    results."""
    if fw_takes_tiled(W.shape[-1]):
        return fw_counts_tiled(W)
    return fw_counts(W)
