"""Shared set-up of the port's CPU tests: each ``tests/test_torch_*.py``
that runs the port on the CPU imports ``one_torch_thread`` (an autouse
fixture, active in every module that imports it)."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU tests run tiny shapes: intra-op threads gain nothing on
    them, and under the suite's parallel workers (``-n 6``) their spinning
    multiplies every worker's wall time.  One thread for the module, the
    previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
