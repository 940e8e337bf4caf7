"""Tensor parallelism and FSDP in the search train step of
``mamba2-780m-smoke`` on a (2, 2) mesh of spawned gloo CPU ranks
(``torch_mesh_train_cases``, layout ``FULL``): ``ssm_inner`` on
``model`` -- ``in_z`` / ``in_x`` / ``conv_x`` / ``ssm_norm`` split by
channel, ``out_proj`` by row, 4 of 8 SSM heads a rank on K5's plain
version, ``in_b`` / ``in_c`` / ``in_dt``, the B / C conv kernels and the
per-head vectors whole with their gradients summed over ``model``, the
norm's sum of squares over the whole ``d_inner`` -- every weight's
``w_embed`` over ``data``, the vocab-parallel embedding and loss, the
sequence split between layers.

Held as ``test_torch_tp_llama.py`` holds its step; the bounds against
the port's own step run shard by shard are 1.5x the largest CPU
readings (loss 1.37e-6, gradients 2.63e-2 relative L2, ``in_b``'s
gamma: its whole weight's gradient is the sum of the ranks' bf16
partial gradients).
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_mesh_train_cases as mc
import torch_tp_cases as tc
from torch_threads import _one_torch_thread  # noqa: F401

ARCH = "mamba2-780m-smoke"
STEP_LOSS, STEP_GRAD = 2.1e-6, 3.9e-2


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
