"""The port's serving stack against the JAX package's on
``minicpm-2b-smoke`` (multi-head attention, served with ``n_kv_heads =
n_heads = 4``); the cases are ``torch_arch_cases.py``'s."""
import pytest

pytest.importorskip("torch")  # the port's optional dependency

from torch_arch_cases import *  # noqa: F401,F403 -- the per-arch cases
from torch_arch_cases import arch_world  # noqa: F401
from torch_threads import _one_torch_thread  # noqa: F401

world = arch_world("minicpm-2b-smoke")
