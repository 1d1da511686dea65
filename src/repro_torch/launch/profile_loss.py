"""Does a large profiled session leave later torch.profiler sessions
without device records?  A measurement of the profiler, for the smoke's
ordering of its profiles (``chip_smoke.profile_phase`` runs before any
profiled train step).

In one process: a session of one ``fw_counts_tiled`` call, a session of
``--trigger`` back-to-back one-element adds, then sessions of one
``fw_counts_tiled`` call, of one add, and of one add then one call; each
line gives the device kernels the session recorded, by name.  Run it once
a trigger size, each in its own process (a card is needed):

    PYTHONPATH=src python -m repro_torch.launch.profile_loss --trigger 30000
    PYTHONPATH=src python -m repro_torch.launch.profile_loss --trigger 150000
"""
from __future__ import annotations

import argparse
from collections import Counter

import torch


def session(label: str, fn) -> None:
    """One torch.profiler session over ``fn``; prints its device kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = Counter(e.name[:40] for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"{label}: {sum(kernels.values())} device kernels "
          f"{dict(kernels.most_common(3))}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trigger", type=int, default=150000,
                    help="one-element adds in the large session")
    args = ap.parse_args()
    from ..kernels import fw_counts_tiled as fwt
    dev = torch.device("cuda", 0)
    W = torch.rand(1, 1536, 1536, device=dev,
                   generator=torch.Generator(dev).manual_seed(0)) + 1
    x = torch.zeros(1024, device=dev)
    fwt.fw_counts_tiled(W)
    torch.cuda.synchronize()

    def adds(n: int) -> None:
        for _ in range(n):
            x.add_(1)

    session("one fw_counts_tiled call", lambda: fwt.fw_counts_tiled(W))
    session(f"{args.trigger} adds", lambda: adds(args.trigger))
    session("then one fw_counts_tiled call", lambda: fwt.fw_counts_tiled(W))
    session("then one add", lambda: adds(1))
    session("then one add and one fw_counts_tiled call",
            lambda: (adds(1), fwt.fw_counts_tiled(W)))


if __name__ == "__main__":
    main()
