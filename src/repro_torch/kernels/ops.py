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
           "FW_TILED_FROM_V"]

# Scorer adapters: ``repro_torch.core.proxies.make_scorer(fw_impl=...)``
# takes a W -> (D, N) callable.  "fw-cuda" binds the one-block-per-placement
# kernel, "fw-ref" the plain version on whatever device W lies, "fw-tiled"
# the size dispatch below.
fw_impl_cuda = fw_counts
fw_impl_ref = ref.fw_counts_ref

# The smallest V at which fw_impl_tiled takes the blocked kernel.  On an
# NVIDIA H100 80GB HBM3 at 700 W, at B = 16, the one-block-per-placement
# kernel was faster at V = 130 (0.59-0.60 against 0.69-0.70 ms) and the
# blocked kernel from V = 160 on (0.68-0.69 against 0.81 ms), in two runs
# of chip_smoke.py's dispatch timing (PERF.md, section 6).
FW_TILED_FROM_V = 160


def fw_impl_tiled(W):
    """Size-dispatched FW: ``fw_counts`` for V < ``FW_TILED_FROM_V``,
    ``fw_counts_tiled`` from there on.  Both are bit for bit equal to
    ``ref.fw_counts_ref``, so the dispatch point is invisible in results."""
    if W.shape[-1] < FW_TILED_FROM_V:
        return fw_counts(W)
    return fw_counts_tiled(W)
