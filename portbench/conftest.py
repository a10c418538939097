"""The benchmark's CPU tests run two torch threads each, and leave the
worker's thread count as they found it (a run sets one)."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
