"""The port's sharded prefill and decode steps on a mesh of two pods
against the JAX package's compiled ones: prefill_32k and decode_32k of
the MoE (moonshot-v1-16b-a3b), dense (qwen3-1.7b) and hybrid
(recurrentgemma-9b) architectures and decode_32k of the SSM
(falcon-mamba-7b) and the encoder-decoder (seamless-m4t-medium), on the
(2, 2, 2) mesh with pods of 4 devices, held as
``test_torch_dryrun_reference_pod.py`` holds the train cells (its
docstring lists the checks).
"""
import pytest

from _torch_dryrun_reference import (POD_DIMS, POD_SERVE_CELLS, POD_SIZE,
                                     check_arguments, check_cross_pod,
                                     check_flops, check_outputs, check_wire,
                                     params, records)
from _torch_threads import one_torch_thread  # noqa: F401

CELLS = POD_SERVE_CELLS


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
