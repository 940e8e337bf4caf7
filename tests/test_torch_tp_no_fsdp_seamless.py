"""Tensor parallelism and the split sequence without FSDP in the search
train step of ``seamless-m4t-medium-smoke`` on a (2, 2) mesh of spawned
gloo CPU ranks (``torch_mesh_train_cases``, layout ``TP``: ``w_embed``
unmapped on both sides), the stub frontends' embeddings fed.  The cross
attention's raw weights are then whole over ``data``; ``wk`` / ``wv``
(each rank its own KV heads) enter the region through ``copy_to``
(``lm._make_getw``), so their gradients are summed over ``model`` as the
decoder's are.

Held as ``test_torch_tp_llama.py`` holds its step; the bounds against
the port's own step run shard by shard are 1.5x the largest CPU
readings: loss 5.6e-6 and gradients 1.05e-2 relative L2 (the encoder's
``wk``).  Against the JAX package's mesh step the worst leaf reads
1.04e-2.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_mesh_train_cases as mc
import torch_tp_cases as tc
from torch_threads import _one_torch_thread  # noqa: F401

ARCH = "seamless-m4t-medium-smoke"
STEP_LOSS, STEP_GRAD = 8.4e-6, 1.6e-2


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
