"""One torch intra-op thread for a port test module.

Beside pytest-xdist's other workers, torch's default intra-op threads
oversubscribe the cores and spin (a 0.7 s search test took 55.7 s, and
``tests/test_torch_sweep.py`` ran 5x slower under ``-n 3``).  A
``tests/test_torch_*.py`` module imports the fixture,

    from torch_threads import _one_torch_thread  # noqa: F401

and runs on one thread, the count restored after it.
"""
import pytest


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
