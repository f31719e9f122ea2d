"""One intra-op thread for the port's CPU tests.

The tests run in several pytest workers on one host, and a PyTorch
thread pool the size of the host in each of them oversubscribes it: the
pools' spinning threads then take the cores that the other workers'
tests need.  A test module imports ``one_torch_thread``, which holds its
worker at one thread for the module's tests and then restores the pool.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
