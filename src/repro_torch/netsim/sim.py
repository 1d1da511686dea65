"""Cycle-level ICI packet simulator — "BookSim2-lite" (paper §VII-A).

A numpy-only copy of ``repro.netsim.sim`` (the port imports nothing of the
JAX package): the host-side *calibration oracle* of the port's netsim
package.  The rate model (``repro_torch.netsim.model``) is validated
against it on relative orderings (see ``tests/test_torch_netsim.py``).

BookSim2 models input-queued VC routers with a four-stage pipeline and
wormhole flow control.  We reproduce the latency-relevant behaviour at the
granularity that the paper's comparisons need (relative latency/throughput of
PlaceIT topologies vs the 2D-mesh baseline):

* chiplet-level routers with a ``router_pipeline``-cycle pipeline per hop,
* wormhole serialization: a link is held for ``flits`` cycles per packet,
* D2D hop latency = 2*L_P + L_L (PHY out + wire + PHY in),
* relay surcharge L_R when a packet passes *through* a chiplet,
* shortest-path routing over the D2D latency graph (non-relay chiplets are
  not valid intermediates),
* dependency-driven injection (Netrace semantics): *authentic* mode injects
  a packet at max(trace cycle, dependency completion); *idealized* mode as
  soon as dependencies are done.

Deviations from BookSim2 (documented, DESIGN.md §3): no VC allocation
conflicts or credit stalls; contention is modeled at link occupancy
granularity.  We validate relative orderings, not absolute cycle counts.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from ..core.chiplets import COMPUTE, IO, MEMORY, ArchSpec
from ..core.topology import PlacedPhys

ROUTER_PIPELINE = 4  # BookSim's 4-stage pipeline (§VII-A)


@dataclass
class ChipletNet:
    """Chiplet-level network extracted from a placement + D2D link list."""

    n: int                      # number of chiplets
    kinds: np.ndarray           # [n] int8
    relay: np.ndarray           # [n] bool
    adj: np.ndarray             # [n, n] float latency (inf if no link)
    next_hop: np.ndarray        # [n, n] int32 routing table (-1 unreachable)
    dist: np.ndarray            # [n, n] float total latency

    @staticmethod
    def from_links(arch: ArchSpec, geo: PlacedPhys,
                   links: list[tuple[int, int]]) -> "ChipletNet":
        n = geo.kinds.shape[0]
        inf = np.float64(np.inf)
        adj = np.full((n, n), inf)
        np.fill_diagonal(adj, 0.0)
        d2d = arch.latency.d2d_cost()
        for p, q in links:
            a, b = int(geo.owner[p]), int(geo.owner[q])
            if a != b:
                adj[a, b] = min(adj[a, b], d2d)
                adj[b, a] = min(adj[b, a], d2d)
        # Shortest paths where intermediate nodes must be relay-capable;
        # a relay hop costs L_R on top of the incident link latencies.
        dist = adj.copy()
        nxt = np.full((n, n), -1, dtype=np.int32)
        for i in range(n):
            for j in range(n):
                if i != j and np.isfinite(adj[i, j]):
                    nxt[i, j] = j
        lr = arch.latency.l_relay
        for k in range(n):
            if not geo.relay[k]:
                continue
            via = dist[:, k:k + 1] + lr + dist[k:k + 1, :]
            upd = via < dist
            np.fill_diagonal(upd, False)
            if upd.any():
                dist = np.where(upd, via, dist)
                nxt = np.where(upd, nxt[:, k:k + 1], nxt)
        return ChipletNet(n=n, kinds=geo.kinds, relay=geo.relay, adj=adj,
                          next_hop=nxt, dist=dist)

    def path(self, src: int, dst: int) -> list[int]:
        if self.next_hop[src, dst] < 0:
            raise ValueError(f"no route {src}->{dst}")
        out = [src]
        while out[-1] != dst:
            out.append(int(self.next_hop[out[-1], dst]))
            if len(out) > self.n + 1:  # pragma: no cover
                raise RuntimeError("routing loop")
        return out


@dataclass(frozen=True)
class Packet:
    """One trace packet.  Pure input data: simulation state (injection and
    completion times) lives in the simulator and in ``SimResult.times``,
    so the same packet list can be re-run under different modes or on
    different networks without carry-over."""

    pid: int
    src: int
    dst: int
    flits: int
    cycle: int                        # earliest injection cycle (trace time)
    deps: tuple[int, ...] = ()        # pids that must complete first


@dataclass
class SimResult:
    n_done: int
    avg_latency: float
    p99_latency: float
    makespan: float
    latencies: np.ndarray | None = field(repr=False, default=None)
    # pid -> (inject_t, finish_t) for every completed packet.
    times: dict[int, tuple[float, float]] | None = field(
        repr=False, default=None)


class NetSim:
    """Event-driven wormhole-lite simulator over a ChipletNet."""

    def __init__(self, net: ChipletNet, arch: ArchSpec):
        self.net = net
        self.arch = arch
        self.hop_lat = arch.latency.d2d_cost() + ROUTER_PIPELINE
        self.relay_lat = arch.latency.l_relay

    def run(self, packets: list[Packet], mode: str = "authentic",
            max_cycles: float = 1e12) -> SimResult:
        """Simulate all packets; returns latency stats.

        mode='authentic': inject at max(cycle, deps done).
        mode='idealized': inject as soon as deps are done (stress test).

        Input packets are never mutated; per-packet injection/finish
        times are reported in ``SimResult.times``.
        """
        assert mode in ("authentic", "idealized")
        by_pid = {p.pid: p for p in packets}
        children: dict[int, list[Packet]] = {}
        n_deps: dict[int, int] = {}
        for p in packets:
            live = [d for d in p.deps if d in by_pid]
            n_deps[p.pid] = len(live)
            for d in live:
                children.setdefault(d, []).append(p)
        link_free: dict[tuple[int, int], float] = {}
        # Event heap: (time, seq, packet)
        heap: list = []
        seq = 0
        for p in packets:
            if n_deps[p.pid] == 0:
                t = float(p.cycle) if mode == "authentic" else 0.0
                heapq.heappush(heap, (t, seq, p))
                seq += 1
        times: dict[int, tuple[float, float]] = {}
        while heap:
            t, _, p = heapq.heappop(heap)
            if t > max_cycles:
                break
            # Route the packet hop by hop, reserving links.
            path = self.net.path(p.src, p.dst)
            now = t
            for h in range(len(path) - 1):
                u, v = path[h], path[h + 1]
                free = link_free.get((u, v), 0.0)
                start = max(now, free)
                # Wormhole: header advances, link busy for `flits` cycles.
                link_free[(u, v)] = start + p.flits
                now = start + self.hop_lat
                if h + 1 < len(path) - 1:       # intermediate chiplet relays
                    now += self.relay_lat
            finish = now + p.flits - 1          # tail flit arrival
            times[p.pid] = (t, finish)
            for ch in children.get(p.pid, []):
                n_deps[ch.pid] -= 1
                if n_deps[ch.pid] == 0:
                    if mode == "authentic":
                        ti = max(float(ch.cycle), finish)
                    else:
                        ti = finish
                    heapq.heappush(heap, (ti, seq, ch))
                    seq += 1
        if not times:
            return SimResult(0, float("nan"), float("nan"), 0.0,
                             np.zeros(0), {})
        lat = np.array([f - i for i, f in times.values()])
        return SimResult(
            n_done=len(times),
            avg_latency=float(lat.mean()),
            p99_latency=float(np.percentile(lat, 99)),
            makespan=float(max(f for _, f in times.values())),
            latencies=lat,
            times=times,
        )


# ---------------------------------------------------------------------------
# Synthetic traffic (paper §VII-B): per-type uniform-random src/dst load.
# ---------------------------------------------------------------------------

def synthetic_packets(net: ChipletNet, traffic: str, rate: float,
                      n_cycles: int, rng: np.random.Generator,
                      data_flits: int = 9) -> list[Packet]:
    """Bernoulli injection per source chiplet at `rate` [packets/cycle].

    traffic in {c2c, c2m, c2i, m2i}; dst drawn uniformly from the dst kind.
    """
    kind_of = {"c": COMPUTE, "m": MEMORY, "i": IO}
    ks, kd = kind_of[traffic[0]], kind_of[traffic[2]]
    srcs = np.nonzero(net.kinds == ks)[0]
    dsts = np.nonzero(net.kinds == kd)[0]
    packets: list[Packet] = []
    pid = 0
    for s in srcs:
        n_inj = rng.binomial(n_cycles, min(rate, 1.0))
        cycles = np.sort(rng.integers(0, n_cycles, size=n_inj))
        for cyc in cycles:
            d = int(rng.choice(dsts))
            if d == int(s):
                continue
            packets.append(Packet(pid, int(s), d, data_flits, int(cyc)))
            pid += 1
    return packets


def latency_throughput_curve(net: ChipletNet, arch: ArchSpec, traffic: str,
                             rates: list[float], n_cycles: int = 2000,
                             seed: int = 0) -> list[tuple[float, float]]:
    """(rate, avg latency) samples; latency diverges past saturation.

    Each rate point draws its traffic from an independent deterministic
    stream seeded by ``(seed, rate index)``, so points are statistically
    independent of each other yet the whole curve is reproducible from
    ``seed`` alone.
    """
    sim = NetSim(net, arch)
    out = []
    for ri, r in enumerate(rates):
        rng = np.random.default_rng((seed, ri))
        pkts = synthetic_packets(net, traffic, r, n_cycles, rng)
        res = sim.run(pkts, mode="authentic")
        out.append((r, res.avg_latency))
    return out
