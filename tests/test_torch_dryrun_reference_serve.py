"""The port's sharded prefill and decode steps against the JAX package's
compiled ones, on a (2, 4) mesh, as ``test_torch_dryrun_reference.py``
holds the train cells (its docstring says how): one dense (qwen3-1.7b),
one MoE (moonshot-v1-16b-a3b), one SSM (falcon-mamba-7b) and one hybrid
(recurrentgemma-9b) architecture, prefill_32k and decode_32k each, and
seamless-m4t-medium's decode.  Per cell, rank 0's

- ``flops_total`` equals the reference's one device's to the FLOP (the
  products of both are whole numbers well inside float64);
- ``argument_size_in_bytes`` is equal (the device's shards of what the
  program reads);
- ``output_size_in_bytes`` differs only by XLA's tuple of the outputs: one
  8-byte pointer a leaf;
- the wire bytes of its collectives, summed, are no more than the
  reference's (the reference's CPU compile runs its all-reduces in
  float32 where the program's values are bfloat16, so its bytes are an
  upper bound that favours it).  A failure prints each kind's count and
  bytes on both sides.

Temp sizes are not compared: the reference's follow the CPU backend's
buffer assignment, which is no yardstick for the card.

Also: ``tests/data/dryrun_reference_single.json`` and
``dryrun_reference_multi.json``, the reference's single-pod and
multi-pod records that the card holds its counts to (it has no JAX),
agree with the reference recompiled here for one cheap cell, and the
port's count of the multi-pod cell passes the card's checks.
"""
import json

import pytest

import _torch_dryrun_reference as ref_dry
from _torch_dryrun_reference import (SERVE_CELLS, check_arguments,
                                     check_flops, check_outputs, check_wire,
                                     params, records)
from _torch_threads import one_torch_thread  # noqa: F401

CELLS = SERVE_CELLS


@pytest.fixture(scope="module")
def recs():
    return records(CELLS)


@pytest.mark.parametrize("key", params(CELLS))
def test_rank_flops_equal_reference(recs, key):
    check_flops(recs, key)


@pytest.mark.parametrize("key", params(CELLS))
def test_argument_bytes_equal_reference(recs, key):
    check_arguments(recs, key)


@pytest.mark.parametrize("key", params(CELLS))
def test_output_bytes_differ_by_the_output_tuple(recs, key):
    check_outputs(recs, key)


@pytest.mark.parametrize("key", params(CELLS))
def test_wire_bytes_at_most_reference(recs, key):
    check_wire(recs, key)


def test_single_pod_file_matches_the_reference():
    """The committed single-pod records: every cell the card checks, and
    qwen3-1.7b decode_32k (a cheap compile) recompiled on 256 host
    devices gives its record again."""
    with open(ref_dry.SINGLE_JSON) as f:
        data = json.load(f)
    assert data["mesh"] == [16, 16] and data["devices"] == 256
    cells = data["cells"]
    for cell in ref_dry.SINGLE_CELLS:
        rec = cells[ref_dry.cell_key(*cell)]
        assert "error" not in rec and rec["flops_total"] > 0
    key = ref_dry.cell_key("qwen3-1.7b", "decode_32k")
    got = ref_dry.reference_records([("qwen3-1.7b", "decode_32k", None)],
                                    dims=(16, 16))[key]
    for field in ref_dry.FIELDS:
        assert got[field] == cells[key][field], field


def test_multi_pod_file_matches_the_reference():
    """The committed multi-pod records (2 x 16 x 16, pods of 256): every
    cell the card checks, with the exact recount of the bytes that cross
    pods; qwen3-1.7b decode_32k recompiled on 512 host devices gives its
    record again, and the port's count of it on fake CPU tensors over 512
    ranks passes the card's checks (FLOPs and arguments equal, wire and
    cross-pod bytes no more, the peak no more)."""
    with open(ref_dry.MULTI_JSON) as f:
        data = json.load(f)
    assert data["mesh"] == [2, 16, 16] and data["devices"] == 512
    assert data["pod_size"] == 256
    cells = data["cells"]
    for cell in ref_dry.MULTI_CELLS:
        rec = cells[ref_dry.cell_key(*cell)]
        assert "error" not in rec and rec["flops_total"] > 0
        assert "cross_pod_exact_bytes_per_chip" in rec["collectives"]
    cell = ("qwen3-1.7b", "decode_32k", None)
    key = ref_dry.cell_key(*cell)
    ref, port = (ref_dry.Worker(side, [cell], (2, 16, 16), pod_size=256)
                 for side in ("reference", "port"))
    got, counted = ref.records()[key], port.records()[key]
    for field in ref_dry.FIELDS:
        assert got[field] == cells[key][field], field
    recs = {key: (cells[key], counted)}
    for check in (check_flops, check_arguments, check_wire,
                  ref_dry.check_cross_pod, ref_dry.check_peak):
        check(recs, key)
