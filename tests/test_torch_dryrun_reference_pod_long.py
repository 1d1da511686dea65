"""The port's sharded train steps of the hybrid and encoder-decoder
families on a mesh of two pods against the JAX package's compiled ones:
recurrentgemma-9b (one whole "rra" block) and seamless-m4t-medium (its
encoder cut as its decoder), on the (2, 2, 2) mesh with pods of 4
devices, held as ``test_torch_dryrun_reference_pod.py`` holds the other
train cells (its docstring lists the checks).
"""
import pytest

from _torch_dryrun_reference import (LONG_CELLS, POD_DIMS, POD_SIZE,
                                     check_arguments, check_cross_pod,
                                     check_flops, check_outputs, check_wire,
                                     params, records)
from _torch_threads import one_torch_thread  # noqa: F401

CELLS = LONG_CELLS


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
