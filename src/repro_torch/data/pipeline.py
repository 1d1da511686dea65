"""Deterministic, shardable, resumable synthetic token pipeline.

The port's own copy of ``repro.data.pipeline``: the same stream, a seeded
counter-mode numpy generator over (seed, step, global row), so any batch
is a pure function of (seed, step, shard) and the cursor is just the step
index.  Batches are made with numpy, bit for bit the reference's, then
placed on the stream's device as int32 tensors.

Documents are Zipf-distributed token runs with BOS/EOS framing, whose
second half repeats the first (so the loss has structure to learn).
Labels are the inputs shifted left; the final position is masked (-1).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.proxies import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard_id: int = 0
    bos: int = 1
    eos: int = 2
    zipf_a: float = 1.3
    doc_len_mean: int = 64

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards


class TokenStream:
    """Stateless batch generator with an explicit integer cursor, on the
    card unless the caller names another device."""

    def __init__(self, cfg: DataConfig, step: int = 0, device=None):
        self.cfg = cfg
        self.step = step
        self.device = resolve_device(device)

    def batch_np(self, step: int) -> dict:
        """The batch at ``step`` as int32 numpy arrays."""
        cfg = self.cfg
        rows = []
        for r in range(cfg.local_batch):
            # Global row id -> the same stream for any sharding layout.
            grow = cfg.shard_id * cfg.local_batch + r
            rng = np.random.default_rng((cfg.seed, step, grow))
            rows.append(self._row(rng))
        tokens = np.stack(rows).astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((tokens.shape[0], 1), -1, np.int32)],
            axis=1)
        return {"tokens": tokens, "labels": labels}

    def batch_at(self, step: int) -> dict:
        """The batch at ``step`` as int32 tensors on the device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.batch_np(step).items()}

    def _row(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        out = np.empty(cfg.seq_len, np.int64)
        i = 0
        while i < cfg.seq_len:
            n = int(rng.geometric(1.0 / cfg.doc_len_mean))
            n = min(max(4, n), cfg.seq_len - i)
            doc = rng.zipf(cfg.zipf_a, size=n) % (cfg.vocab - 3) + 3
            # Learnable structure: the second half of a doc repeats the
            # first.
            half = n // 2
            doc[half:half * 2] = doc[:half]
            doc[0] = cfg.bos
            if i + n < cfg.seq_len:
                doc[-1] = cfg.eos
            out[i:i + n] = doc
            i += n
        return out

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    # -- cursor (checkpoint extras) -----------------------------------------
    def cursor(self) -> dict:
        return {"step": self.step}

    @classmethod
    def from_cursor(cls, cfg: DataConfig, cursor: dict,
                    device=None) -> "TokenStream":
        return cls(cfg, step=int(cursor.get("step", 0)), device=device)
