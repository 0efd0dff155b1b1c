"""A fixture for the port's CPU tests (no test of its own): few PyTorch
threads.

The suite runs under several pytest-xdist workers on one shared host. An
eager PyTorch SLAM run is thousands of small ops, each an OpenMP region
over every core; with more runnable threads than cores each region waits
for threads that are not scheduled, and a run that takes 15 s alone took
700 s under six workers. Two threads cost such a run a factor of two when
it has the host to itself and take the oversubscription away.

Import it into a test module to have it apply to that module:
    from test_torch_threads import few_torch_threads  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
