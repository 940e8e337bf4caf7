"""The port's MoE model and server against the JAX package's on
``llama4-scout-17b-a16e-smoke`` (3 chunked + 1 full attention layers, 4
experts, top-1, a shared FFN); the cases are ``torch_moe_cases.py``'s."""
import pytest

pytest.importorskip("torch")  # the port's optional dependency

from torch_moe_cases import *  # noqa: F401,F403 -- the per-arch cases
from torch_moe_cases import arch_world  # noqa: F401
from torch_threads import _one_torch_thread  # noqa: F401

world = arch_world("llama4-scout-17b-a16e-smoke")
