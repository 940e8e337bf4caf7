"""The full placements in the search train step of
``arctic-480b-smoke`` on a (2, 2) mesh of spawned gloo CPU ranks
(``torch_mesh_train_cases``, layout ``FULL``): tensor-parallel attention
and shared FFN, the experts on ``model`` with the MoE input gathered
along the split sequence (the capacity still a data shard's tokens),
every weight's and bank's ``w_embed`` over ``data``, each bank's Eq. 5
absmax over both axes.  ``tests/test_torch_mesh_train.py`` holds the
expert-parallel layout alone.

Held as ``test_torch_tp_llama.py`` holds its step.  Against the port's
own step run shard by shard: the tensor-parallel sums move the MoE
input by a rounding, and one of the 32 tokens a data shard routes then
lands on another expert at the capacity boundary, which moves every
leaf's gradient.  The bounds are 1.5x the largest CPU reading of each
class of leaves (``STEP_GRAD``, relative L2): the router 0.138, the
expert banks 0.120 (``w_down``), the shared FFN 4.96e-2, attention
and the layer norms 7.48e-2 (``norm1``), the embedding, head and final
norm 5.88e-2 (``embed``); the loss 1.19e-4.  The JAX package's own mesh
step lies as far from its ``shards`` function, leaf by leaf (13.9% the
router, 4.3-12.0% the rest), and the port's mesh step lies within
1.25e-2 of the JAX mesh step on every leaf: the same token reroutes
there, so that comparison holds every leaf to the single-device 3e-2.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_mesh_train_cases as mc
import torch_tp_cases as tc
from torch_threads import _one_torch_thread  # noqa: F401

ARCH = "arctic-480b-smoke"
STEP_LOSS = 1.8e-4
STEP_GRAD = {"ffn/router": 0.21, "ffn/shared": 7.5e-2, "ffn/": 0.18,
             "blocks/": 0.11, "": 9e-2}


@pytest.fixture(scope="module")
def world():
    return tc.world(ARCH, (2, 2))


def test_shard_shapes_are_the_references(world):
    tc.check_shapes(world)


def test_step_matches_own_and_jax_steps(world):
    mc.check_step(world, STEP_GRAD, STEP_LOSS)


def test_replicated_leaves_agree_on_every_rank(world):
    tc.check_replicated(world)


def test_checkpoint_restores_under_other_meshes(world):
    tc.check_restore(world)
