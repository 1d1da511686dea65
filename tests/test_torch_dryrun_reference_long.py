"""The port's sharded train steps of the hybrid and encoder-decoder
families against the JAX package's compiled ones: recurrentgemma-9b (one
whole "rra" block) and seamless-m4t-medium (its encoder cut as its
decoder), on a (2, 4) mesh, as ``test_torch_dryrun_reference.py`` holds
the other train cells (its docstring says how).  Per cell, rank 0's

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
"""
import pytest

from _torch_dryrun_reference import (LONG_CELLS, check_arguments,
                                     check_flops, check_outputs, check_wire,
                                     params, records)
from _torch_threads import one_torch_thread  # noqa: F401

CELLS = LONG_CELLS


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
