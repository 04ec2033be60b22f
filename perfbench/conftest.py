"""pytest settings of the benchmark's own tests (`perfbench/test_perfbench_
*.py`): the `card` marker of the tests that need a CUDA card, decided
inside the `card` fixture, never while a module is imported."""

import pytest
import torch

# torch's intra-op pool makes the tiny CPU tensors of these tests slow
torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one); run on the "
        "card with `python3 -m pytest perfbench -m card`")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs on the card only")
    return torch.device("cuda")
