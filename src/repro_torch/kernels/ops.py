"""Public kernel API.  Dispatch is by the tensor's device: a CUDA tensor
goes to the hand-written kernel (which raises if it cannot build or
launch), a CPU tensor to the plain PyTorch version."""
from __future__ import annotations

from . import ref
from .fw_counts import fw_counts  # noqa: F401  (re-exported)

# Scorer adapters: ``repro_torch.core.proxies.make_scorer(fw_impl=...)``
# takes a W -> (D, N) callable.  "fw-cuda" binds the kernel wrapper,
# "fw-ref" the plain version on whatever device W lies.
fw_impl_cuda = fw_counts
fw_impl_ref = ref.fw_counts_ref
