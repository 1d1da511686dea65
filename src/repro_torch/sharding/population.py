"""Population-axis sharding for stacked ScoreGraph scoring.

The port of ``repro.sharding.population``.  The batched scorer
(``proxies.make_scorer``) is elementwise over its leading population axis:
every row is one placement's ScoreGraph plus its per-row normalizer and
weight vectors.  That makes device parallelism a pure data partition:
:func:`shard_scorer` splits the stacked batch into one contiguous slice
per device, scores each slice with that device's copy of the scorer
(``score.on_device``), and concatenates the results — no collectives at
all.  Every slice is enqueued before any result is copied back, so the
devices score their slices at the same time.

Rows are padded (by repeating row 0) to a multiple of the device count
and the padding is cut off on the way out, so any batch size works.  A
row's results do not depend on the chunk it is scored in (the scorer is
chunk-invariant bit for bit), so the sharded call equals the unsharded
one bit for bit, on one device or several.
"""
from __future__ import annotations

import numpy as np
import torch


def population_devices(devices=None) -> list[torch.device]:
    """The devices the population axis is split over: ``devices`` as
    ``torch.device``s, or every CUDA device by default."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "population sharding over every CUDA device needs a card; "
                "pass an explicit device list (e.g. ['cpu', 'cpu'])")
        return [torch.device("cuda", i) for i in range(n)]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("population sharding needs at least one device")
    return devs


def n_pop_devices(devices=None) -> int:
    return len(population_devices(devices))


def _per_row(v, rows: int) -> np.ndarray:
    """Broadcast a [D] runtime vector to per-row [rows, D] (already-2-D
    vectors pass through) so it splits along the population axis like the
    batch."""
    v = np.asarray(v, np.float32)
    if v.ndim == 1:
        v = np.broadcast_to(v, (rows,) + v.shape)
    return np.ascontiguousarray(v)


def _pad(v, pad: int):
    """``v`` with its row 0 repeated ``pad`` times at the end."""
    if isinstance(v, torch.Tensor):
        return torch.cat([v, v[:1].expand((pad,) + tuple(v.shape[1:]))])
    v = np.asarray(v)
    return np.concatenate([v, np.repeat(v[:1], pad, axis=0)])


def shard_scorer(scorer, devices=None):
    """Wrap a batched scorer so that the population axis is split across
    ``devices`` (default: every CUDA device, :func:`population_devices`).

    Returns ``call(batch, norms, weights) -> metrics`` with the scorer's
    signature and output (float32 numpy arrays, ``connected`` as bool);
    ``norms`` / ``weights`` may be single vectors or per-row matrices
    (they are broadcast per row before the split, which is value-identical
    to the scorer's own broadcast).
    """
    devs = population_devices(devices)
    n = len(devs)
    scorers = [scorer.on_device(d) for d in devs]

    def call(batch, norms=None, weights=None):
        rows = int(batch["W"].shape[0])
        pad = (-rows) % n
        vecs = [None if v is None else _per_row(v, rows)
                for v in (norms, weights)]
        if pad:
            batch = {k: _pad(v, pad) for k, v in batch.items()}
            vecs = [None if v is None else _pad(v, pad) for v in vecs]
        per = (rows + pad) // n
        outs = []
        for i, sc in enumerate(scorers):
            sl = slice(i * per, (i + 1) * per)
            outs.append(sc.tensors(
                {k: v[sl] for k, v in batch.items()},
                *(None if v is None else v[sl] for v in vecs)))
        return {k: np.concatenate([o[k].cpu().numpy() for o in outs])[:rows]
                for k in outs[0]}

    call.devices = devs
    call.n_devices = n
    return call
