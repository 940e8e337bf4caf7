"""``tests/test_torch_mesh_train.py``'s step check for
``llama4-scout-17b-a16e-smoke`` (one super-block of 3 chunked + 1 full
attention layers, 4 experts top-1 and the shared FFN on every layer):
the (2, 2) search train step of spawned gloo ranks under the
expert-parallel layout against the JAX package's (2, 2) mesh step,
within the single-device step's bounds widened by 1.5x the JAX
package's own spread between its mesh step and its ``shards`` function;
every replicated leaf the same on all ranks; the state's checkpoint
restored under (1, 4) bitwise."""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_mesh_train_cases as mc
from torch_threads import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def world():
    return mc.mesh_world("llama4-scout-17b-a16e-smoke")


def test_step_matches_the_jax_mesh_step(world):
    mc.check_step(world)


def test_replicated_leaves_and_restore(world):
    assert all(r["replicated_same"] and r["restored_other"]
               for r in world["ranks"])
