"""Batched serving engine: prefill + decode with slot-based continuous
batching.  The port of ``repro.serve.engine``.

The engine owns a fixed pool of ``n_slots`` sequences and decodes the
whole pool in one batched ``decode_step`` per tick.  Requests join free
slots through a per-request prefill, whose cache is written into the
pool at the request's slot; finished slots (EOS or max_tokens) free at
once and the queue refills them.  Same slot semantics, retire rule and
sampling as the reference: greedy by default, and with a temperature the
reference's ``default_rng(0)`` draw.

Beyond the reference, the engine keeps host-clock counters in ``stats``
(seconds and tokens of prefill and of decode; each ends in a
device-to-host copy of the logits or tokens, so the device work is done)
and each request's ``t_first``, the host time of its first token.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.model import LM
from ..models.tree import tree_map


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [S] int32
    max_tokens: int = 32
    out_tokens: list = field(default_factory=list)
    done: bool = False
    t_first: float | None = None       # time.monotonic() of token 1


@dataclass
class EngineConfig:
    n_slots: int = 4
    cache_len: int = 256
    eos: int = 2
    temperature: float = 0.0           # 0 -> greedy


class ServeEngine:
    def __init__(self, model: LM, cfg: EngineConfig):
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.caches = model.init_cache(cfg.n_slots, cfg.cache_len)
        self.lengths = np.zeros(cfg.n_slots, np.int32)
        self.last_tok = np.zeros(cfg.n_slots, np.int32)
        self.slot_req: list[Request | None] = [None] * cfg.n_slots
        self.queue: list[Request] = []
        self.stats = {"prefill_s": 0.0, "prefill_tokens": 0,
                      "decode_s": 0.0, "decode_tokens": 0}

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _join(self, slot: int, req: Request):
        t0 = time.monotonic()
        prompt = torch.as_tensor(np.asarray(req.prompt)[None],
                                 dtype=torch.long, device=self.device)
        logits, cache1 = self.model.prefill({"tokens": prompt},
                                            self.cfg.cache_len)
        # Write the single-row prefill cache into the pooled cache at `slot`.
        for pool, one in zip(self.caches, cache1):
            tree_map(lambda p, o: p[:, slot].copy_(o[:, 0]), pool, one)
        tok = self._sample_rows(logits)[0]
        self.slot_req[slot] = req
        self.lengths[slot] = len(req.prompt)
        self.last_tok[slot] = tok
        req.out_tokens.append(tok)
        req.t_first = time.monotonic()
        self.stats["prefill_s"] += req.t_first - t0
        self.stats["prefill_tokens"] += len(req.prompt)

    def _sample(self, logits: np.ndarray) -> int:
        if self.cfg.temperature <= 0:
            return int(np.argmax(logits))
        p = np.exp((logits - logits.max()) / self.cfg.temperature)
        p /= p.sum()
        return int(np.random.default_rng(0).choice(len(p), p=p))

    def _sample_rows(self, logits: torch.Tensor) -> list[int]:
        """One token per row of [B, V] logits.  Greedy takes the argmax on
        the device (the first maximum, as ``np.argmax``) and copies back B
        ints; with a temperature the logits come to the host."""
        if self.cfg.temperature <= 0:
            return logits.argmax(-1).tolist()
        return [self._sample(row) for row in logits.cpu().numpy()]

    def _retire(self, slot: int):
        req = self.slot_req[slot]
        req.done = True
        self.slot_req[slot] = None
        self.lengths[slot] = 0

    # ------------------------------------------------------------------
    def step(self):
        """One engine tick: refill slots, batched decode, retire finished."""
        for slot in range(self.cfg.n_slots):
            if self.slot_req[slot] is None and self.queue:
                self._join(slot, self.queue.pop(0))
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        t0 = time.monotonic()
        batch = {
            "tokens": torch.as_tensor(self.last_tok[:, None],
                                      dtype=torch.long, device=self.device),
            "lengths": torch.as_tensor(self.lengths, dtype=torch.int32,
                                       device=self.device),
        }
        logits = self.model.decode_step(batch, self.caches)
        toks = self._sample_rows(logits)
        self.stats["decode_s"] += time.monotonic() - t0
        self.stats["decode_tokens"] += len(active)
        for slot in active:
            tok = toks[slot]
            req = self.slot_req[slot]
            req.out_tokens.append(tok)
            self.lengths[slot] += 1
            self.last_tok[slot] = tok
            hit_eos = tok == self.cfg.eos
            full = (len(req.out_tokens) >= req.max_tokens
                    or int(self.lengths[slot]) + 1 >= self.cfg.cache_len)
            if hit_eos or full:
                self._retire(slot)
        return True

    def run(self, max_ticks: int = 10_000) -> int:
        ticks = 0
        while ticks < max_ticks and (self.queue
                                     or any(self.slot_req)):
            if not self.step():
                break
            ticks += 1
        return ticks
