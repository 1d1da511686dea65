"""Latency / throughput proxies (paper §IV-A, RapidChiplet-style), in PyTorch.

The port of ``repro.core.proxies``.  Given a batch of ``ScoreGraph``s we
compute, per placement and per traffic type t in {C2C, C2M, C2I, M2I}
(directed: C->C, C->M, C->I, M->I):

* ``lat_t``  — mean shortest-path latency [cycles] over (src, dst) chiplet
  pairs of the type, on the PHY-level graph (relay semantics encoded in the
  graph construction, see ``topology.py``).
* ``thr_t``  — sustainable per-source injection rate (fraction of theoretical
  peak, in [0, 1]): uniform-random traffic of the type is routed over all
  shortest paths with ECMP splitting (Brandes path-counting); the bottleneck
  link determines the saturation rate  alpha* = 1 / max_link_load.

Everything rests on one batched Floyd-Warshall with shortest-path counts
(``fw_impl``): by default the size dispatch between the two hand-written
CUDA kernels on the card (``repro_torch.kernels.ops.fw_impl_tiled``), the
plain PyTorch versions on the CPU.
The rest is plain tensor code with the placement dimension written out.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.ops import fw_impl_tiled
from ..kernels.ref import INF_CUT
from .chiplets import COMPUTE, IO, MEMORY, ArchSpec
from .objective import (NORM_DIM, TRACE_TERMS, compile_objective,
                        weights_vec)

# Per-chunk element budget for the scorer's dominant intermediates (the
# [V, V] FW matrices and the [S, E, T] ECMP tensor, times the chunk).  A
# memory bound only: results do not depend on the chunk.  Every paper arch
# keeps its full default chunk (V <= ~450 -> clamp inactive).
_CHUNK_ELEM_BUDGET = 1 << 26


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another (the tests pass ``device="cpu"``).  Without a card and without
    an explicit device this raises, as it does for an explicit "cuda":
    there is no quiet CPU run."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the port "
            "on the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    return torch.device("cuda", torch.cuda.current_device())


@dataclass(frozen=True)
class Layout:
    """Static (arch-level) node layout shared by every placement in a batch."""

    Vp: int
    kinds: tuple[int, ...]    # chiplet kind per instance

    @property
    def N(self) -> int:
        return len(self.kinds)

    def src_nodes(self, kind: int) -> np.ndarray:
        base = self.Vp
        return np.array([base + c for c, k in enumerate(self.kinds)
                         if k == kind], dtype=np.int32)

    def dst_nodes(self, kind: int) -> np.ndarray:
        base = self.Vp + self.N
        return np.array([base + c for c, k in enumerate(self.kinds)
                         if k == kind], dtype=np.int32)


def layout_for(arch: ArchSpec) -> Layout:
    Vp = sum(ch.n_phys() for ch in arch.chiplets)
    return Layout(Vp=Vp, kinds=arch.kinds())


def _type_pairs(layout: Layout) -> dict:
    """Static (srcs, dsts, same_kind) node-index sets per traffic type."""
    ep = {
        "c2c": (COMPUTE, COMPUTE),
        "c2m": (COMPUTE, MEMORY),
        "c2i": (COMPUTE, IO),
        "m2i": (MEMORY, IO),
    }
    out = {}
    for t, (ks, kd) in ep.items():
        out[t] = (layout.src_nodes(ks), layout.dst_nodes(kd), ks == kd)
    return out


def max_pair_elems(layout: Layout) -> int:
    """S * T of the traffic type with the most (source, sink) pairs."""
    return max(len(s) * len(d) for s, d, _ in _type_pairs(layout).values())


def scorer_chunk(pair_elems: int, V: int, n_edges: int, chunk: int) -> int:
    """Placements per FW call: ``chunk`` clamped so that one chunk's
    dominant intermediates (the [V, V] FW matrices and the [S, E, T] ECMP
    tensor, ``pair_elems`` = :func:`max_pair_elems`) stay within
    ``_CHUNK_ELEM_BUDGET`` elements each.  A memory bound only: results do
    not depend on the chunk."""
    per = max(V * V, pair_elems * n_edges)
    return max(1, min(chunk, _CHUNK_ELEM_BUDGET // per))


@dataclass(frozen=True)
class _PairSet:
    """One traffic type's index sets and demand, on the scorer's device."""

    srcs: torch.Tensor        # [S] long, virtual source nodes
    dsts: torch.Tensor        # [T] long, virtual sink nodes
    pair_ok: torch.Tensor     # [S, T] bool, excludes the self pair
    n_pairs: int
    dem: torch.Tensor         # [S, T] float32 uniform demand per source


def _pair_sets(layout: Layout, device: torch.device) -> dict:
    out = {}
    for t, (srcs, dsts, same) in _type_pairs(layout).items():
        S, T = len(srcs), len(dsts)
        # Exclude the self pair (src chiplet == dst chiplet): the node sets
        # enumerate the same chiplets in the same order.
        pair_ok = (~torch.eye(S, dtype=torch.bool, device=device) if same
                   else torch.ones(S, T, dtype=torch.bool, device=device))
        dem = pair_ok.to(torch.float32) / pair_ok.sum(
            1, keepdim=True).clamp_min(1)
        out[t] = _PairSet(
            torch.as_tensor(srcs, dtype=torch.long, device=device),
            torch.as_tensor(dsts, dtype=torch.long, device=device),
            pair_ok, int(pair_ok.sum()), dem)
    return out


def _rows(M: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[P, V, V], per-placement row indices [P, K] -> [P, K, V]."""
    return M.gather(1, idx[:, :, None].expand(-1, -1, M.shape[-1]))


def _cols(M: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[P, K, V], per-placement column indices [P, E] -> [P, K, E]."""
    return M.gather(2, idx[:, None, :].expand(-1, M.shape[1], -1))


def _metrics_one(W, edges, edge_mask, area, *, pairs, conn, fw_impl,
                 dem_vec=None, trace_fn=None):
    """All nine cost components plus ``connected`` for a batch of
    placements: W [P,V,V], edges [P,E,2] long, edge_mask [P,E], area [P].

    The reference's per-placement ``_metrics_one`` with the placement
    dimension written out: the same gathers, the [P, S, E, T]
    on-shortest-path mask and one contraction for the ECMP link loads.
    With packed demand rows ``dem_vec`` [P, demand_dim(N)] and a
    ``trace_fn`` (the netsim rate model bound to this layout), the output
    also carries the per-class ``trace_lat_{t}`` / ``trace_thr_{t}``
    traffic metrics, computed from the same FW solve."""
    D, Ncnt = fw_impl(W)
    eu, ev = edges[..., 0], edges[..., 1]                      # [P, E]
    V = W.shape[-1]
    w_e = W.reshape(W.shape[0], -1).gather(1, eu * V + ev)     # [P, E]
    out = {"area": area}
    # In-scorer connectivity: the placement is connected iff every virtual
    # source reaches every virtual sink.
    src_all, dst_all = conn
    out["connected"] = (D[:, src_all][:, :, dst_all] < INF_CUT).flatten(
        1).all(1)
    for t, ps in pairs.items():
        D_s = D[:, ps.srcs]                                     # [P, S, V]
        N_s = Ncnt[:, ps.srcs]
        Dsd = D_s[:, :, ps.dsts]                                # [P, S, T]
        lat = (torch.where(ps.pair_ok, Dsd, 0.0).sum((1, 2))
               / max(ps.n_pairs, 1))
        # --- ECMP link loads (Brandes fractions) -------------------------
        Dsu = _cols(D_s, eu)                                    # [P, S, E]
        Nsu = _cols(N_s, eu)
        Dvd = _rows(D, ev)[:, :, ps.dsts]                       # [P, E, T]
        Nvd = _rows(Ncnt, ev)[:, :, ps.dsts]
        Nsd = N_s[:, :, ps.dsts].clamp_min(1.0)
        on_sp = ((Dsu[:, :, :, None] + w_e[:, None, :, None]
                  + Dvd[:, None, :, :] - Dsd[:, :, None, :]).abs() < 0.5
                 ) & (Dsd[:, :, None, :] < INF_CUT)
        frac = Nsu[:, :, :, None] * Nvd[:, None, :, :] / Nsd[:, :, None, :]
        # The reference's einsum("st,set->e") per placement, written as a
        # product and a sum over (s, t): unlike a batched matmul, whose
        # kernel changes with the batch size, this keeps the float32
        # summation order of each placement independent of the chunk.
        load = (ps.dem[:, None, :] * torch.where(on_sp, frac, 0.0)).sum(
            (1, 3))
        load = torch.where(edge_mask, load, 0.0)
        max_load = load.max(1).values
        thr = torch.where(max_load > 0, (1.0 / max_load).clamp_max(1.0), 1.0)
        out[f"lat_{t}"] = lat
        out[f"thr_{t}"] = thr
    if dem_vec is not None and trace_fn is not None:
        out.update(trace_fn(D, Ncnt, W, edges, edge_mask, dem_vec))
    return out


# The dtype each key of a scoring batch takes on the scorer's device.
BATCH_DTYPES = {"W": torch.float32, "edges": torch.long,
                "edge_mask": torch.bool, "area": torch.float32,
                "edge_len": torch.float32, "_demand": torch.float32}


def _tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def batch_tensor(key: str, x, device) -> torch.Tensor:
    """One key of a scoring batch (numpy or a tensor on any device) as a
    tensor on ``device`` in the dtype the scorer reads it in."""
    return _tensor(x, BATCH_DTYPES.get(key), device)


def make_scorer(layout: Layout, *, fw_impl=fw_impl_tiled, chunk: int = 16,
                objective=None, device=None):
    """Build a batched scorer: dict of stacked arrays -> metric dict.

    ``score(batch, norms=None, weights=None)`` takes the stacked ScoreGraph
    arrays (numpy or tensors: ``W``, ``edges``, ``edge_mask``, ``area``,
    ``edge_len``), moves them to the scorer's device, scores them in chunks
    of ``chunk`` placements and returns float32 numpy arrays (``connected``
    as bool), like the reference's jitted scorer.  ``score.tensors(...)``
    returns the same dict as tensors on the device; ``score.device`` is
    that device, and ``score.on_device(d)`` the same scorer (layout, FW,
    chunk, objective) on device ``d`` (itself on its own device).

    With an ``objective`` the output gains a per-placement ``cost``; the
    normalizers (``[NORM_DIM]`` or per-row ``[P, NORM_DIM]``) and weights
    (``[W_FIXED + n_terms]`` or ``[P, ...]``, default the objective's own
    :func:`~repro_torch.core.objective.weights_vec`) are runtime arguments.

    When the objective carries a trace term (``trace-lat`` /
    ``trace-thr``), the batch must also carry a ``_demand`` key (``[P,
    demand_dim(N)]`` packed workload rows, see
    :mod:`repro_torch.netsim.workload`); the traffic rate model then runs
    after the FW call on the same ``D``, ``N`` and the output gains
    per-class ``trace_lat_{t}`` / ``trace_thr_{t}`` metrics and
    ``trace_max_load``.  Demand is a runtime operand like norms and
    weights, and the chunk clamp then counts the rate model's ``[N, E,
    N]`` tensor too.
    """
    dev = resolve_device(device)
    pairs = _pair_sets(layout, dev)
    conn = (layout.Vp + torch.arange(layout.N, device=dev),
            layout.Vp + layout.N + torch.arange(layout.N, device=dev))
    cobj = compile_objective(objective) if objective is not None else None
    default_w = weights_vec(objective) if objective is not None else None
    Vp = layout.Vp
    pair_elems = max_pair_elems(layout)
    needs_demand = objective is not None and any(
        t.name in TRACE_TERMS for t in objective.terms)
    trace_fn = None
    if needs_demand:
        # Lazy import: netsim.model imports this module; proxy-only
        # scorers keep the traffic model out of their import graph.
        from ..netsim.model import trace_metrics_one
        trace_fn = functools.partial(trace_metrics_one, srcs=conn[0],
                                     dsts=conn[1])
        # The rate model's [N, E, N] tensor joins the chunk budget.
        pair_elems = max(pair_elems, layout.N * layout.N)

    def score_tensors(batch, norms=None, weights=None) -> dict:
        W = batch_tensor("W", batch["W"], dev)
        edges = batch_tensor("edges", batch["edges"], dev)
        edge_mask = batch_tensor("edge_mask", batch["edge_mask"], dev)
        area = batch_tensor("area", batch["area"], dev)
        edge_len = (batch_tensor("edge_len", batch["edge_len"], dev)
                    if "edge_len" in batch else None)
        P = W.shape[0]
        dem = None
        if needs_demand:
            if "_demand" not in batch:
                raise ValueError(
                    "objective has a trace term (trace-lat/trace-thr) but "
                    "the batch carries no '_demand' workload operand; "
                    "score through an Evaluator built with a workload "
                    "(see repro_torch.netsim.workload.Workload)")
            dem = batch_tensor("_demand", batch["_demand"], dev)
            dem = dem.expand(P, dem.shape[-1])
        eff = scorer_chunk(pair_elems, W.shape[-1], edges.shape[1], chunk)
        if cobj is not None:
            norms = torch.ones(NORM_DIM) if norms is None else norms
            norms = _tensor(norms, torch.float32, dev).expand(P, NORM_DIM)
            weights = default_w if weights is None else weights
            weights = _tensor(weights, torch.float32, dev)
            weights = weights.expand(P, weights.shape[-1])
        parts = []
        for s in range(0, P, eff):
            c = slice(s, s + eff)
            out = _metrics_one(W[c], edges[c], edge_mask[c], area[c],
                               pairs=pairs, conn=conn, fw_impl=fw_impl,
                               dem_vec=None if dem is None else dem[c],
                               trace_fn=trace_fn)
            if cobj is not None:
                sample = dict(out, edges=edges[c], edge_mask=edge_mask[c],
                              area=area[c], Vp=Vp)
                if edge_len is not None:
                    sample["edge_len"] = edge_len[c]
                out["cost"] = cobj.cost(sample, norms[c], weights[c])
            parts.append(out)
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def score(batch, norms=None, weights=None) -> dict:
        out = score_tensors(batch, norms, weights)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def on_device(device):
        d = resolve_device(device)
        if d == dev:
            return score
        return make_scorer(layout, fw_impl=fw_impl, chunk=chunk,
                           objective=objective, device=d)

    score.tensors = score_tensors
    score.device = dev
    score.on_device = on_device
    return score


def make_ranker(scorer):
    """Score a batch and select the ``k`` best placements (ascending cost)
    on the scorer's device.  ``scorer`` must have been built with an
    objective (it emits ``cost``).  Returns ``rank(batch, norms, k, valid,
    weights) -> (costs [k], indices [k])`` as numpy; rows where ``valid`` is
    False rank last with infinite cost.  Ties keep the lower index first,
    as ``jax.lax.top_k`` does in the reference."""
    def rank(batch, norms, k: int = 1, valid=None, weights=None):
        cost = scorer.tensors(batch, norms, weights)["cost"]
        if valid is not None:
            ok = _tensor(valid, torch.bool, cost.device)
            cost = torch.where(ok, cost, torch.inf)
        idx = torch.sort(cost, stable=True).indices[:k]
        return cost[idx].cpu().numpy(), idx.cpu().numpy()

    return rank

