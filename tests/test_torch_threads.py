"""The one-thread fixture the port's CPU test files share.

The tier-1 run drives six test processes on the machine's cores at once
(``-n 6``).  PyTorch's default is a thread a core in each, and OpenMP
threads spin after each parallel region, so a process of many small ops
waits on cores the other five hold (``ROADMAP.md``, "Tier-1 time": an LSTM
test ran 100x slower so).  A port test file takes the port onto one torch
thread and one BLAS thread for its whole module:

    from test_torch_threads import one_thread  # noqa: F401 (autouse)

and the previous counts come back after the module's last test.
"""

import pytest
import threadpoolctl
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread and one BLAS thread for the module's tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def test_one_thread_in_the_module():
    assert torch.get_num_threads() == 1
    assert all(p["num_threads"] == 1
               for p in threadpoolctl.threadpool_info())
