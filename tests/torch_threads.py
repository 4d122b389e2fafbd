"""A module-scoped autouse fixture for the port's CPU test modules of tiny
models: run the module on one intra-op thread, then restore the count.

The suite runs in several worker processes on one host's cores; each
PyTorch process defaults to one intra-op thread a core, so the workers
oversubscribe the cores and tiny ops spend their time waiting for
threads. Import ``one_thread`` into a test module to use it."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
