"""``test_torch_tp_llama.py``'s step checks for ``llama3.2-1b-smoke`` on
a (1, 4) mesh: one query head and a quarter of the FFN columns and of
the vocab a rank (four ranks share each of the 2 KV heads in pairs), a
quarter of the sequence's rows between layers, no FSDP.  The bounds and
why are that file's; the saved state restores under (2, 2)."""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import test_torch_tp_llama as tl
import torch_mesh_train_cases as mc
import torch_tp_cases as tc
from torch_threads import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def world():
    return tc.world(tl.ARCH, (1, 4))


def test_shard_shapes_are_the_references(world):
    tc.check_shapes(world)


def test_step_matches_own_and_jax_steps(world):
    mc.check_step(world, tl.STEP_GRAD, tl.STEP_LOSS)


def test_replicated_leaves_and_restore(world):
    tc.check_replicated(world)
    tc.check_restore(world)
