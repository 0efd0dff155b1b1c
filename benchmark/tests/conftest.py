"""Few PyTorch threads for the benchmark's CPU tests (eager SLAM runs are
many small OpenMP regions; several pytest workers oversubscribe the
cores otherwise), and the `cuda` fixture that skips a test without a
card, decided when the test runs."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
