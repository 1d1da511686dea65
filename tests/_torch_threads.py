"""One torch intra-op thread for the port's CPU tests.

pytest-xdist runs several workers side by side; torch's default of one
thread per core in each of them oversubscribes the machine many times over
and slows the plain Floyd-Warshall loop by an order of magnitude.  Import
the fixture into a test module to run its tests single-threaded.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
