"""The AdamW update of the sharded train step on a mesh of pods, counted.

On a ("pod", "data", "model") mesh the dry run lays the parameters out
FSDP-split over "data" and the optimizer state over ("pod", "data")
(hierarchical ZeRO, as the reference's ``launch.dryrun``).  The update
moves each such leaf's gradient and parameter to the state's layout and
its new parameter back by collectives that the port chooses
(``sharding.partition.state_plan``), not DTensor's planner, so that
every torch release runs one program.  Rank 0's program of
moonshot-v1-16b-a3b's and qwen3-1.7b's train_4k cells (2 layers) on a
fake (2, 2, 2) mesh, pods of 4 (``_torch_dryrun_reference.port_record``,
in a process of its own), is held to that:

- the update (``train/optimizer.py``) runs collective-permutes, one
  all-gather over the pod axis a leaf and the global norm's scalar
  all-reduces, and no all-to-all;
- their bytes equal a count from the leaves' shapes: for a leaf whose
  state shard holds n entries, the gradient's (float32 once microbatches
  are summed) and the parameter's permutes of n entries, the new
  parameter's of n, and its all-gather over the P pods of P n entries
  (the ring's (P - 1) / P of them on the wire); the gradient, a partial
  sum over the pods until then, reaches its state shard by one
  reduce-scatter over the pods ((P - 1) n entries on the wire) and its
  permute before the global norm (``_reduce_over_pods``);
- the step's placing of the new state afterwards moves nothing: the
  train step's own lines run only the metrics' scalar all-reduces.

Beside them, the multi-pod cells ((2, 16, 16), pods of 256) are counted
again and held to ``tests/data/dryrun_port_multi.json``, this torch
release's counts, which ``chip_smoke.py`` holds the card's release to
(rewrite it with ``PYTHONPATH=src python tests/_torch_dryrun_reference.py
--port tests/data/dryrun_port_multi.json --mesh multi`` where a change
moves them).
"""
import dataclasses
import json
import math

import pytest

from _torch_dryrun_reference import (FIELDS, MULTI_CELLS, MULTI_DIMS,
                                     POD_DIMS, POD_SIZE, PORT_MULTI_JSON,
                                     Worker, cell_key, params, parse_key)
from _torch_threads import one_torch_thread  # noqa: F401

CELLS = [("moonshot-v1-16b-a3b", "train_4k", {"n_layers": 2}),
         ("qwen3-1.7b", "train_4k", {"n_layers": 2})]
KEYS = [cell_key(*c) for c in CELLS]


@pytest.fixture(scope="module")
def workers():
    """The port's counts of the pod cells and of the multi-pod ones, each
    in a process of its own, side by side."""
    return (Worker("port", CELLS, POD_DIMS, pod_size=POD_SIZE),
            Worker("port", MULTI_CELLS, MULTI_DIMS, pod_size=256))


@pytest.fixture(scope="module")
def recs(workers):
    return workers[0].records()


@pytest.fixture(scope="module")
def multi(workers):
    return workers[1].records()


def _sites(rec, where: str) -> dict:
    """{kind: [count, wire]} summed over the collective sites whose line
    is in ``where`` (``file:`` and function name)."""
    file, func = where.split(" ")
    out: dict = {}
    for path, kinds in rec["collective_sites"].items():
        if path.startswith(file) and path.endswith(" " + func):
            for kind, (n, w) in kinds.items():
                e = out.setdefault(kind, [0, 0.0])
                e[0] += n
                e[1] += w
    return out


def _rank0_entries(shape, spec, sizes: dict) -> int:
    """Rank 0's entries of a leaf of ``shape`` laid out by ``spec``: each
    dim split by its axes in turn, chunk 0 of each (ceil)."""
    n = 1
    for length, entry in zip(shape, spec):
        for a in _axes(entry):
            length = -(-length // sizes[a])
        n *= length
    return n


def _axes(entry) -> tuple:
    """The mesh axes a spec entry names."""
    return () if entry is None else \
        entry if isinstance(entry, tuple) else (entry,)


def _shards(spec, sizes: dict) -> int:
    """The number of distinct shards a spec cuts a leaf into."""
    return math.prod(sizes[a] for entry in spec for a in _axes(entry))


def expected_update_wire(key: str, microbatches: int) -> tuple:
    """(collective-permute bytes, all-gather wire bytes) of rank 0's
    update from the leaves' shapes, and the number of moved leaves."""
    from repro_torch.launch.dryrun import prod_config
    from repro_torch.models.model import LM

    arch, shape, cut = parse_key(key)
    cfg = dataclasses.replace(prod_config(arch, shape)[0], **cut)
    sizes = dict(zip(("pod", "data", "model"), POD_DIMS))
    params = dict(LM(cfg, "meta").named_parameters())
    p_specs, s_specs = _specs(cfg, params, shape, sizes)
    P = sizes["pod"]
    permute = gather = moved = 0
    for name, p in params.items():
        if p_specs[name] == s_specs[name]:
            continue
        n = _rank0_entries(p.shape, s_specs[name], sizes)
        # Even splits: every shard, and so every part the pod group
        # gathers, holds n entries.
        assert n * _shards(s_specs[name], sizes) == math.prod(p.shape)
        eb = p.element_size()
        gb = 4 if microbatches > 1 else eb      # float32 accumulation
        permute += n * gb + 2 * n * eb
        gather += P * n * eb * (P - 1) / P
        moved += 1
    return permute, gather, moved


def reduce_scatter_wire(key: str, microbatches: int) -> float:
    """The wire bytes of rank 0's reduce-scatters over the P pods of the
    moved leaves' gradients (float32 once microbatches are summed): n
    entries a leaf each rank keeps, (P - 1) n sent."""
    from repro_torch.launch.dryrun import prod_config
    from repro_torch.models.model import LM

    arch, shape, cut = parse_key(key)
    cfg = dataclasses.replace(prod_config(arch, shape)[0], **cut)
    params = dict(LM(cfg, "meta").named_parameters())
    sizes = dict(zip(("pod", "data", "model"), POD_DIMS))
    p_specs, s_specs = _specs(cfg, params, shape, sizes)
    total = 0
    for name, p in params.items():
        if p_specs[name] != s_specs[name]:
            gb = 4 if microbatches > 1 else p.element_size()
            total += (sizes["pod"] - 1) * gb * _rank0_entries(
                p.shape, s_specs[name], sizes)
    return total


def _specs(cfg, params, shape, sizes) -> tuple:
    """The parameters' and the AdamW state's specs on the pod mesh."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import mesh_info_for
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.sharding import rules

    mi = mesh_info_for(ShapeMesh(sizes), SHAPES[shape].global_batch)
    mi_opt = dataclasses.replace(mi, fsdp_over=tuple(mi.dp))
    return (rules.param_pspecs(cfg, params, mi),
            rules.param_pspecs(cfg, params, mi_opt))


@pytest.mark.parametrize("key", KEYS)
def test_update_runs_no_all_to_all(recs, key):
    sites = _sites(recs[key], "optimizer.py adamw_update")
    assert set(sites) <= {"collective-permute", "all-gather/cross-pod",
                          "all-reduce"}, sites
    assert sites.get("collective-permute", [0])[0] > 0
    assert not any(k.startswith("all-to-all") for path in
                   recs[key]["collective_sites"]
                   if "optimizer.py" in path
                   for k in recs[key]["collective_sites"][path])


@pytest.mark.parametrize("key", KEYS)
def test_update_bytes_equal_the_count_from_shapes(recs, key):
    rec = recs[key]
    permute, gather, moved = expected_update_wire(key, rec["microbatches"])
    assert moved > 0
    sites = _sites(rec, "optimizer.py adamw_update")
    # The gradient's permute runs where its partial sum over the pods is
    # reduce-scattered to the state's layout, before the global norm.
    first = _sites(rec, "optimizer.py _reduce_over_pods")
    n, w = first["collective-permute"]
    assert [sites["collective-permute"][0] + n,
            sites["collective-permute"][1] + w] == [3 * moved, permute]
    assert first["reduce-scatter/cross-pod"] == [
        moved, reduce_scatter_wire(key, rec["microbatches"])]
    assert sites["all-gather/cross-pod"] == [moved, gather]
    # The global norm: scalars only, no gather of whole gradients.
    n, w = _sites(rec, "optimizer.py global_norm").get("all-reduce",
                                                        [0, 0.0])
    assert n > 0 and w <= 8 * n
    assert "all-reduce" not in sites or sites["all-reduce"][1] <= 64


@pytest.mark.parametrize("key", KEYS)
def test_new_state_is_placed_without_moving(recs, key):
    sites = _sites(recs[key], "step.py train_step")
    assert set(sites) <= {"all-reduce", "all-reduce/cross-pod"}, sites
    for n, w in sites.values():
        assert w <= 8 * n


@pytest.mark.parametrize("key", params(MULTI_CELLS))
def test_multi_pod_port_file_holds_this_tree_s_counts(multi, key):
    with open(PORT_MULTI_JSON) as f:
        there = json.load(f)[key]
    for field in FIELDS + ("microbatches",):
        assert there[field] == multi[key][field], field
