import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")


@pytest.fixture
def few_threads():
    """Tiny CPU products run faster on one thread than on a pool."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
