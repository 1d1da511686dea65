"""The port's sharded train steps on a mesh of two pods against the JAX
package's compiled ones.

The same cells as ``test_torch_dryrun_reference.py`` (its docstring says
how they are compiled and counted), on a (2, 2, 2) mesh of ("pod",
"data", "model") axes with pods of 4 devices, whose policy the dry run's
multi-pod mesh follows: FSDP inside a pod, the pod axis plain data
parallelism, the optimizer state split over ("pod", "data").  Per cell,
rank 0's

- ``flops_total`` equals the reference's one device's to the FLOP (on a
  pod mesh XLA computes the MoE router's weight gradient whole on each
  rank: ``sharding.partition._row_block_plan``);
- ``argument_size_in_bytes`` is equal;
- ``output_size_in_bytes`` differs only by XLA's tuple of the outputs: one
  8-byte pointer a leaf;
- the wire bytes of its collectives, summed, are no more than the
  reference's;
- the wire bytes of the collectives that cross pods are no more than the
  reference's, recounted from the compiled groups
  (``_torch_dryrun_reference.exact_crosses``; the reference's own rule
  misses the (pod, data) groups XLA writes in iota form).

This file holds the dense, SSM, MoE and replicated train cells;
``test_torch_dryrun_reference_pod_long.py`` the hybrid and
encoder-decoder ones, and ``test_torch_dryrun_reference_pod_serve.py``
the prefill and decode cells.
"""
import pytest

from _torch_dryrun_reference import (POD_DIMS, POD_SIZE, TRAIN_CELLS,
                                     check_arguments, check_cross_pod,
                                     check_flops, check_outputs, check_wire,
                                     params, records)
from _torch_threads import one_torch_thread  # noqa: F401

CELLS = TRAIN_CELLS


@pytest.fixture(scope="module")
def recs():
    return records(CELLS, POD_DIMS, POD_SIZE)


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


@pytest.mark.parametrize("key", params(CELLS))
def test_cross_pod_bytes_at_most_exact_recount(recs, key):
    check_cross_pod(recs, key)
