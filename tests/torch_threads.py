"""Two intra-op threads for the port's tests on the CPU.

The tier-1 run takes six test files at a time (pytest-xdist workers), and
PyTorch gives each process as many OpenMP threads as the host has cores:
six pools of busy-waiting threads on one host's cores slowed the port's
tests about threefold against two threads a worker (six of the heaviest
files: 507 s against 165 s on an 8-core host). Every ``test_torch_*.py``
that computes on the CPU imports this autouse fixture, which sets two
threads for its module and restores the count after it. The card tests do
not.
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)
