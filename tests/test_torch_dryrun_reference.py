"""The port's sharded train steps against the JAX package's compiled ones.

The same cell (architecture, shape, the production overrides and
layouts), at full width with its depth cut, on a (2, 4) mesh of ("data",
"model") axes: the reference lowers and compiles ``repro.launch.dryrun.
build_cell`` over 8 host devices whose axes are Auto and reads it with its
own ``analyze`` (``tests/_torch_dryrun_reference.py``: one JAX process for
the file's cells, run while the port counts); the port executes rank 0's
program on fake tensors over a fake group of 8 ranks
(``repro_torch.launch.dryrun.count_cell``).  Per cell, rank 0's

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

This file holds the dense, SSM, MoE and replicated (sequence-parallel)
train cells; ``test_torch_dryrun_reference_long.py`` the hybrid and
encoder-decoder ones (the longest compiles), and
``test_torch_dryrun_reference_serve.py`` the prefill and decode cells.
"""
import pytest

from _torch_dryrun_reference import (TRAIN_CELLS, check_arguments,
                                     check_flops, check_outputs, check_wire,
                                     params, records)
from _torch_threads import one_torch_thread  # noqa: F401

CELLS = TRAIN_CELLS


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
