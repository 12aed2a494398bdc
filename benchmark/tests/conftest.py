"""The benchmark's CPU tests: ``python3 -m pytest benchmark/tests -q``.

One marker, ``card``, marks a test that needs a CUDA card; such a test
decides inside itself whether there is one and skips on the CPU."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips on the CPU)")


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    # several test workers each spinning a thread per core make torch's
    # small CPU ops many times slower
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
