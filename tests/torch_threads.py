"""One torch intra-op thread for the test modules that import
:func:`one_torch_thread`: the suite runs several pytest workers on the
machine's cores, and torch's default of one intra-op thread a core in
each worker oversubscribes them (the heaviest port files ran about five
times slower under six workers than with one thread each)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
