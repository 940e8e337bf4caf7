"""``test_torch_tp_no_fsdp.py``'s checks for ``mamba2-780m-smoke`` on a
(2, 2) mesh with ``w_embed`` unmapped: 4 of 8 SSM heads a rank, ``in_b``
/ ``in_c`` / ``in_dt`` whole on every rank and their gradients summed
over ``model``.  The bounds are 1.5x the largest CPU readings against
the port's own step run shard by shard: loss 1.41e-6, gradients 2.59e-2
relative L2 (``in_b``'s gamma)."""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_mesh_train_cases as mc
import torch_tp_cases as tc
from torch_threads import _one_torch_thread  # noqa: F401

ARCH = "mamba2-780m-smoke"
STEP_LOSS, STEP_GRAD = 2.1e-6, 3.9e-2


@pytest.fixture(scope="module")
def world():
    return tc.world(ARCH, (2, 2), mc.TP)


def test_shard_shapes_are_the_references(world):
    tc.check_shapes(world)


def test_step_matches_own_and_jax_steps(world):
    mc.check_step(world, STEP_GRAD, STEP_LOSS)


def test_replicated_leaves_agree_on_every_rank(world):
    tc.check_replicated(world)


def test_checkpoint_restores_under_other_meshes(world):
    tc.check_restore(world)
