"""Tensor parallelism, FSDP and the split sequence in the search train
step of ``qwen2-vl-72b-smoke`` on a (2, 2) mesh of spawned gloo CPU
ranks (``torch_mesh_train_cases``, layout ``FULL``), fed the stub
vision frontend's ``embeddings`` (``steps.batch_struct``'s batch): each
rank keeps its rows of their sequence (``sharding.seq_block``), and
from there the VLM is a dense decoder under the placements of
``test_torch_tp_llama.py`` (the embedding table takes no gradient).

Held as ``test_torch_tp_llama.py`` holds its step; the bounds against
the port's own step run shard by shard are 1.5x the largest CPU
readings: loss 4.5e-6 and gradients 9.6e-3 relative L2 (``norm1``).
Against the JAX package's mesh step the worst leaf reads 7.2e-3.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_mesh_train_cases as mc
import torch_tp_cases as tc
from torch_threads import _one_torch_thread  # noqa: F401

ARCH = "qwen2-vl-72b-smoke"
STEP_LOSS, STEP_GRAD = 6.7e-6, 1.44e-2


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
