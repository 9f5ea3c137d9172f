"""The benchmark's own tests: on the CPU at tiny films, the program running
its kernels' plain versions; ``cuda``-marked tests need the card."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread while a test runs: several test workers would
    otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, never while
    a module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda:0")
