"""The torch thread cap of the CPU tests, in a module that imports
neither JAX nor the JAX package, so that test files which also hold card
tests can take it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several xdist workers: keep torch to one intra-op
    thread each instead of oversubscribing the cores. Module scope, so it
    also covers the module-scoped fixtures that run a whole slice."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
