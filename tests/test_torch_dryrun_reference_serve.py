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

Also: ``tests/data/dryrun_reference_single.json``, the reference's
single-pod records that the card holds its counts to (it has no JAX),
agrees with the reference recompiled here for one cheap cell.
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
