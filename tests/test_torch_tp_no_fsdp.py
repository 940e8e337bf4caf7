"""Tensor parallelism and the split sequence without FSDP: the search
train step of ``llama3.2-1b-smoke`` (``mamba2-780m-smoke``'s is
``test_torch_tp_no_fsdp_mamba.py``) on a (2, 2) mesh of spawned gloo
CPU ranks under the reference's rules with ``w_embed`` unmapped
(``torch_mesh_train_cases``, layout ``TP``), on both sides: every
weight whole over ``data``, each data rank's gradient all-reduced over
it by the step.  A weight no mesh axis splits but a
tensor-parallel region uses in part -- attention's ``wk`` / ``wv`` (each
rank's own KV heads), Mamba-2's ``in_b`` / ``in_c`` / ``in_dt`` (each
rank's own SSM heads) -- enters the region through ``copy_to``, so its
gradient is summed over ``model``.

Held as ``test_torch_tp_llama.py`` holds its step.  The bounds against
the port's own step run shard by shard are 1.5x the largest CPU
readings: loss 1.42e-5 and gradients 1.32e-2 relative L2 (``embed``).
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_mesh_train_cases as mc
import torch_tp_cases as tc
from torch_threads import _one_torch_thread  # noqa: F401

ARCH = "llama3.2-1b-smoke"
STEP_LOSS, STEP_GRAD = 2.2e-5, 2.0e-2


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
