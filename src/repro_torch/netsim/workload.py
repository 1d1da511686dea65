"""Traffic workloads as fixed-shape demand tensors.

The port of ``repro.netsim.workload`` (numpy only; the same JSON form and
digest as the reference's, so a workload written by either package loads
in the other).  A :class:`Workload` compiles either a dependency trace
(``core.traces``) or §VII-B synthetic traffic into per-traffic-class
chiplet-pair packet rates plus per-class mean packet sizes:

* ``rate [K, n, n]`` — packets/cycle injected from chiplet ``s`` to
  chiplet ``d``, per traffic class (``K = len(TRAFFIC_TYPES)``),
* ``flits [K]``     — mean flits per packet of that class.

The shape depends only on the chiplet count ``n``, never on the trace
content, so a workload is a *runtime operand* of the scorer (like the
norm/weight vectors): swapping traces or scaling injection rates
re-dispatches the same scorer with a different ``[DEM]`` vector
(``DEM = demand_dim(n)``).

Workloads are value-hashable (content digest) and JSON-serde-able, so
they participate in evaluator/scorer cache keys (``ExperimentConfig``)
and cross-config stacking.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from ..core.chiplets import COMPUTE, IO, MEMORY, TRAFFIC_TYPES

K = len(TRAFFIC_TYPES)

# (src kind, dst kind) -> traffic-class index.  Classes fold direction:
# a memory->compute reply accounts under "c2m" just like the request.
_CLASS_OF = {
    (COMPUTE, COMPUTE): 0,
    (COMPUTE, MEMORY): 1, (MEMORY, COMPUTE): 1,
    (COMPUTE, IO): 2, (IO, COMPUTE): 2,
    (MEMORY, IO): 3, (IO, MEMORY): 3,
}

_KIND_OF = {"c": COMPUTE, "m": MEMORY, "i": IO}


def demand_dim(n: int) -> int:
    """Length of the packed demand vector for an ``n``-chiplet arch."""
    return K * n * n + K


@dataclass(frozen=True, eq=False)
class Workload:
    """Per-class chiplet-pair packet rates + mean packet sizes.

    Equality and hashing are by content digest, so structurally equal
    workloads (e.g. deserialized copies) share evaluator cache entries.
    """

    n: int                       # chiplets
    rate: np.ndarray             # [K, n, n] float32 packets/cycle
    flits: np.ndarray            # [K] float32 mean flits/packet
    name: str = ""
    _digest: str = field(init=False, repr=False, default="")

    def __post_init__(self):
        rate = np.ascontiguousarray(np.asarray(self.rate, np.float32))
        flits = np.ascontiguousarray(np.asarray(self.flits, np.float32))
        if rate.shape != (K, self.n, self.n):
            raise ValueError(
                f"rate must be [K={K}, n={self.n}, n={self.n}], "
                f"got {rate.shape}")
        if flits.shape != (K,):
            raise ValueError(f"flits must be [{K}], got {flits.shape}")
        rate.setflags(write=False)
        flits.setflags(write=False)
        object.__setattr__(self, "rate", rate)
        object.__setattr__(self, "flits", flits)
        h = hashlib.sha256()
        h.update(np.int64(self.n).tobytes())
        h.update(rate.tobytes())
        h.update(flits.tobytes())
        object.__setattr__(self, "_digest", h.hexdigest()[:16])

    # -- identity ----------------------------------------------------------

    def digest(self) -> str:
        return self._digest

    def __hash__(self):
        return hash((self.n, self._digest))

    def __eq__(self, other):
        return (isinstance(other, Workload) and self.n == other.n
                and self._digest == other._digest)

    def __repr__(self):
        tot = float(self.rate.sum())
        return (f"Workload(n={self.n}, name={self.name!r}, "
                f"total_rate={tot:.4g}, digest={self._digest})")

    # -- device operand ----------------------------------------------------

    def vec(self) -> np.ndarray:
        """Packed ``[demand_dim(n)]`` float32 runtime operand: raveled
        per-class rates followed by the per-class flit sizes."""
        return np.concatenate(
            [self.rate.ravel(), self.flits]).astype(np.float32)

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_trace(packets, kinds, n_cycles: int,
                   name: str = "trace") -> "Workload":
        """Compile a packet trace (``core.traces.generate_trace`` output,
        or any iterable with ``src``/``dst``/``flits`` fields) into mean
        injection rates over ``n_cycles`` cycles.

        ``kinds`` is the per-chiplet kind array (e.g. ``net.kinds``).
        Packets whose (src kind, dst kind) pair maps to no paper traffic
        class (e.g. memory-to-memory) are ignored.
        """
        kinds = np.asarray(kinds)
        n = int(kinds.shape[0])
        if n_cycles <= 0:
            raise ValueError(f"n_cycles must be positive, got {n_cycles}")
        rate = np.zeros((K, n, n), np.float64)
        fl_sum = np.zeros(K, np.float64)
        fl_cnt = np.zeros(K, np.float64)
        for p in packets:
            k = _CLASS_OF.get((int(kinds[p.src]), int(kinds[p.dst])))
            if k is None or p.src == p.dst:
                continue
            rate[k, p.src, p.dst] += 1.0
            fl_sum[k] += p.flits
            fl_cnt[k] += 1.0
        rate /= float(n_cycles)
        flits = np.where(fl_cnt > 0, fl_sum / np.maximum(fl_cnt, 1.0), 1.0)
        return Workload(n=n, rate=rate, flits=flits, name=name)

    @staticmethod
    def synthetic(kinds, traffic: str, rate: float,
                  data_flits: int = 9, name: str = "") -> "Workload":
        """§VII-B synthetic load: every source chiplet of the class's src
        kind injects ``rate`` packets/cycle, spread uniformly over the
        destination kind (matching ``sim.synthetic_packets`` semantics).
        """
        if traffic not in TRAFFIC_TYPES:
            raise ValueError(
                f"unknown traffic type {traffic!r}; one of {TRAFFIC_TYPES}")
        kinds = np.asarray(kinds)
        n = int(kinds.shape[0])
        k = TRAFFIC_TYPES.index(traffic)
        ks, kd = _KIND_OF[traffic[0]], _KIND_OF[traffic[2]]
        srcs = np.nonzero(kinds == ks)[0]
        dsts = np.nonzero(kinds == kd)[0]
        dem = np.zeros((K, n, n), np.float64)
        for s in srcs:
            tgt = dsts[dsts != s]
            if tgt.size:
                dem[k, s, tgt] = rate / tgt.size
        flits = np.full(K, 1.0)
        flits[k] = float(data_flits)
        return Workload(n=n, rate=dem, flits=flits,
                        name=name or f"synthetic-{traffic}")

    def scaled(self, factor: float) -> "Workload":
        """Same spatial pattern at ``factor``x the injection rate."""
        return Workload(n=self.n, rate=self.rate * float(factor),
                        flits=self.flits, name=self.name)

    # -- serde -------------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "n": self.n,
            "rate": np.asarray(self.rate, np.float64).tolist(),
            "flits": np.asarray(self.flits, np.float64).tolist(),
            "name": self.name,
        }

    @staticmethod
    def from_dict(d: dict) -> "Workload":
        extra = set(d) - {"n", "rate", "flits", "name"}
        if extra:
            raise ValueError(f"unknown Workload keys: {sorted(extra)}")
        return Workload(n=int(d["n"]), rate=np.asarray(d["rate"]),
                        flits=np.asarray(d["flits"]),
                        name=str(d.get("name", "")))
