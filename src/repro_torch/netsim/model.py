"""Traffic rate model over stacked ScoreGraphs, in PyTorch.

The port of ``repro.netsim.model``: the searchable counterpart of the
event-driven oracle in ``repro_torch.netsim.sim``, a batched queueing
approximation whose per-placement outputs (``trace_lat_{t}`` /
``trace_thr_{t}`` per traffic class) the ``trace-lat`` / ``trace-thr``
objective terms turn into cost summands, so placements are optimized
*directly against traffic* instead of the uniform-pair proxies.

Per placement, given the Floyd-Warshall distances ``D`` and shortest-path
counts ``Ncnt`` the proxy scorer already computes:

1. distribute each chiplet pair's packet rate over all equal-cost
   shortest paths with ECMP/Brandes fractions (the same
   on-shortest-path test as the throughput proxy),
2. accumulate per-link *flit* loads ``rho`` [flits/cycle],
3. charge a saturating M/M/1-style queueing delay
   ``q = min(rho / (1 - rho), Q_CAP)`` per traversed link (clipped, so
   past-saturation placements rank by how overloaded they are instead of
   producing inf/nan),
4. per-pair latency = path latency ``D[s, d]`` + router pipeline per hop
   + queueing along the path + serialization (``flits - 1``), reduced to
   a demand-weighted mean per traffic class.

Demand enters as a packed runtime operand (``workload.Workload.vec()``,
one row per placement), so one scorer serves every workload and a stacked
call carries each run's own demand rows.

The placement dimension is written out, as in ``core.proxies``.  Each of
the reference's contractions (``einsum`` over the chiplet pairs or the
links) is a product followed by sums over single axes of at most
``max(n, E)`` elements: a batched matmul, or one sum over all ``n * n``
pairs, may change its summation order with the number of placements in
the call, and the scorer's chunk boundaries move when runs are stacked.
Calibration against the event-driven simulator is on *relative
orderings* across placements (rank correlation, see
``tests/test_torch_netsim.py``), not absolute cycle counts.
"""
from __future__ import annotations

import torch

from ..core.chiplets import TRAFFIC_TYPES
from ..kernels.ops import fw_impl_tiled
from ..kernels.ref import INF_CUT
from .sim import ROUTER_PIPELINE
from .workload import K, demand_dim

# Queueing-delay divergence cap [cycles]: rho/(1-rho) saturates here, so
# an overloaded link costs a large-but-finite, still-monotone penalty.
Q_CAP = 1.0e4

TRACE_METRIC_KEYS = (
    tuple(f"trace_lat_{t}" for t in TRAFFIC_TYPES)
    + tuple(f"trace_thr_{t}" for t in TRAFFIC_TYPES)
    + ("trace_max_load",))


def unpack_demand(dem_vec, n: int):
    """Split packed ``[..., demand_dim(n)]`` rows into (``rate [..., K, n,
    n]``, ``flits [..., K]``); numpy arrays or tensors."""
    lead = tuple(dem_vec.shape[:-1])
    rate = dem_vec[..., :K * n * n].reshape(lead + (K, n, n))
    flits = dem_vec[..., K * n * n:]
    return rate, flits


def _rows(M: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[P, V, V], per-placement row indices [P, K] -> [P, K, V]."""
    return M.gather(1, idx[:, :, None].expand(-1, -1, M.shape[-1]))


def _cols(M: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[P, K, V], per-placement column indices [P, E] -> [P, K, E]."""
    return M.gather(2, idx[:, None, :].expand(-1, M.shape[1], -1))


def _pair_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing (s, t) pair axes, one axis at a time."""
    return x.sum(-1).sum(-1)


def _link_load(dem: torch.Tensor, use: torch.Tensor) -> torch.Tensor:
    """einsum("st,set->e") per placement: dem [P, n, n], use [P, n, E, n]
    -> [P, E]."""
    return (dem[:, :, None, :] * use).sum(-1).sum(1)


def trace_metrics_one(D, Ncnt, W, edges, edge_mask, dem_vec, *, srcs, dsts,
                      router_pipeline: float = ROUTER_PIPELINE) -> dict:
    """Traffic metrics for a batch of placements: ``D``, ``Ncnt``, ``W``
    [P, V, V], ``edges`` [P, E, 2] long, ``edge_mask`` [P, E], ``dem_vec``
    [P, demand_dim(n)] (the reference's per-placement function with the
    placement dimension written out).

    ``srcs``/``dsts`` are the virtual source/sink node indices of the
    arch's chiplets (``layout.Vp + i`` / ``layout.Vp + N + i``, long
    tensors), so chiplet-level demand maps onto the PHY-level FW matrices.
    Returns ``[P]`` tensors: ``trace_lat_{t}`` per traffic class (0 where
    the class has no demand), ``trace_thr_{t}`` — the class's maximum
    sustainable aggregate injection rate [flits/cycle]: its demand scaled
    by the largest factor alpha that keeps every link load under capacity
    given the *other* classes' fixed loads (``alpha = min_e headroom_e /
    rho_k_e``, capped at ``Q_CAP``) — and ``trace_max_load`` (bottleneck
    link flit load).
    """
    n = srcs.shape[0]
    rate, flits = unpack_demand(dem_vec, n)                  # [P,K,n,n]
    eu, ev = edges[..., 0], edges[..., 1]                    # [P, E]
    V = W.shape[-1]
    w_e = W.reshape(W.shape[0], -1).gather(1, eu * V + ev)   # [P, E]
    D_s, N_s = D[:, srcs], Ncnt[:, srcs]                     # [P, n, V]
    Dsd = D_s[:, :, dsts]                                    # [P, n, n]
    Dsu, Nsu = _cols(D_s, eu), _cols(N_s, eu)                # [P, n, E]
    Dvd = _rows(D, ev)[:, :, dsts]                           # [P, E, n]
    Nvd = _rows(Ncnt, ev)[:, :, dsts]
    Nsd = N_s[:, :, dsts].clamp_min(1.0)
    # ECMP: edge (u, v) lies on a shortest s->d path iff
    # D[s,u] + w(u,v) + D[v,d] == D[s,d]; the Brandes fraction
    # N[s,u]*N[v,d]/N[s,d] is the share of s->d traffic crossing it.
    # Padded edge rows ((0, 0), weight 0) would pass the on-path test
    # spuriously, so the mask applies *inside* the selection.
    on_sp = (((Dsu[:, :, :, None] + w_e[:, None, :, None]
               + Dvd[:, None, :, :] - Dsd[:, :, None, :]).abs() < 0.5)
             & (Dsd[:, :, None, :] < INF_CUT)
             & edge_mask[:, None, :, None])
    use = torch.where(
        on_sp, Nsu[:, :, :, None] * Nvd[:, None, :, :] / Nsd[:, :, None, :],
        0.0)                                                 # [P,n,E,n]
    # Per-link flit load, summed over classes, and its queueing delay.
    # rho/(1-rho) counts waits in units of the link's mean *service* time
    # (wormhole holds a link `flits` cycles per packet), so it is scaled
    # by the link's flits-per-packet to land in cycles.
    fk = rate * flits[:, :, None, None]                      # [P,K,n,n]
    rho = _link_load(fk.sum(1), use)                         # [P, E]
    pkt = _link_load(rate.sum(1), use)
    serv = rho / pkt.clamp_min(1e-12)                        # cycles/packet
    q = (serv * rho / (1.0 - rho).clamp_min(1.0 / Q_CAP)).clamp_max(Q_CAP)
    queue = (use * q[:, None, :, None]).sum(2)               # [P, n, n]
    hops = use.sum(2)                                        # D2D hops
    reach = Dsd < INF_CUT
    base = torch.where(reach, Dsd + router_pipeline * hops + queue, 0.0)
    # Per-class link loads and the saturation throughput: scale class k's
    # demand by alpha until its most loaded link exhausts the headroom the
    # other classes leave (1 - sum_{j!=k} rho_j); unreachable pairs carry
    # no `use` so they never load a link.  Classes using no link (or with
    # no demand) get alpha = Q_CAP / thr = 0 respectively.
    rho_k = torch.stack([_link_load(fk[:, k], use) for k in range(K)],
                        1)                                   # [P, K, E]
    other = (rho[:, None, :] - rho_k).clamp_min(0.0)
    ratio = torch.where(
        edge_mask[:, None, :] & (rho_k > 1e-12),
        (1.0 - other).clamp_min(1.0 / Q_CAP) / rho_k.clamp_min(1e-12),
        torch.inf)
    alpha = ratio.min(-1).values.clamp_max(Q_CAP)            # [P, K]
    out = {"trace_max_load":
           torch.where(edge_mask, rho, 0.0).max(-1).values}
    for k, t in enumerate(TRAFFIC_TYPES):
        r = torch.where(reach, rate[:, k], 0.0)
        tot = _pair_sum(r)
        lat = (_pair_sum(r * base) / tot.clamp_min(1e-12)
               + (flits[:, k] - 1.0))
        out[f"trace_lat_{t}"] = torch.where(tot > 0, lat, 0.0)
        out[f"trace_thr_{t}"] = torch.where(
            tot > 0, alpha[:, k] * tot * flits[:, k], 0.0)
    return out


# Placements per FW call of make_trace_model, before the scorer's clamp.
_CHUNK = 16


def make_trace_model(layout, *, fw_impl=fw_impl_tiled,
                     router_pipeline: float = ROUTER_PIPELINE, device=None):
    """Standalone batched rate model on ``device`` (default: the card):
    ``model(batch, demand)`` maps a stacked ScoreGraph batch (``W
    [P,V,V]``, ``edges``, ``edge_mask``; numpy or tensors) plus a packed
    demand operand (``[DEM]`` shared, or ``[P, DEM]`` per-row) to a dict of
    ``[P]`` float32 numpy arrays (``TRACE_METRIC_KEYS``);
    ``model.tensors`` returns them as tensors on the device.

    Inside the search pipeline the same computation runs fused into
    ``proxies.make_scorer``; this entry point serves calibration tests and
    benchmarks that want traffic metrics without an objective.  Placements
    go through ``fw_impl`` (by default the size dispatch between the CUDA
    FW kernels on the card, the plain versions on the CPU) in chunks
    clamped like the scorer's (``proxies.scorer_chunk``), the model's
    ``[N, E, N]`` tensor counted.
    """
    from ..core.proxies import batch_tensor, resolve_device, scorer_chunk
    dev = resolve_device(device)
    srcs = layout.Vp + torch.arange(layout.N, device=dev)
    dsts = srcs + layout.N
    dim = demand_dim(layout.N)

    def tensors(batch, demand) -> dict:
        W = batch_tensor("W", batch["W"], dev)
        edges = batch_tensor("edges", batch["edges"], dev)
        mask = batch_tensor("edge_mask", batch["edge_mask"], dev)
        P = W.shape[0]
        dem = batch_tensor("_demand", demand, dev).expand(P, dim)
        eff = scorer_chunk(layout.N * layout.N, W.shape[-1], edges.shape[1],
                           _CHUNK)
        parts = []
        for s in range(0, P, eff):
            c = slice(s, s + eff)
            D, Ncnt = fw_impl(W[c])
            parts.append(trace_metrics_one(
                D, Ncnt, W[c], edges[c], mask[c], dem[c], srcs=srcs,
                dsts=dsts, router_pipeline=router_pipeline))
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def model(batch, demand) -> dict:
        return {k: v.cpu().numpy() for k, v in tensors(batch, demand).items()}

    model.tensors = tensors
    model.device = dev
    return model
