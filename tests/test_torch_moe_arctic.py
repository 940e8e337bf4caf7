"""The port's MoE model and server against the JAX package's on
``arctic-480b-smoke`` (full attention, 4 experts, top-2, a shared FFN);
the cases are ``torch_moe_cases.py``'s."""
import pytest

pytest.importorskip("torch")  # the port's optional dependency

from torch_moe_cases import *  # noqa: F401,F403 -- the per-arch cases
from torch_moe_cases import arch_world  # noqa: F401
from torch_threads import _one_torch_thread  # noqa: F401

world = arch_world("arctic-480b-smoke")
