"""Tensor parallelism, FSDP and the split sequence in the search train
step of ``seamless-m4t-medium-smoke`` on a (2, 2) mesh of spawned gloo
CPU ranks (``torch_mesh_train_cases``, layout ``FULL``), fed
``steps.batch_struct``'s batch: the decoder's and the encoder's stub
frontend embeddings, each rank's rows of their sequences between layers.
The encoder's bidirectional attention and FFN are regions over
``model`` like the decoder's, ``enc_norm`` and ``norm_cross`` run on the
split sequence (their gradients summed over its group), and the cross
attention is a region too: its raw float32 weights placed as the dense
ones are (``lm._RAW``: ``wq`` / ``wo`` split over ``model``, ``wk`` /
``wv`` whole and sliced to the rank's KV heads, every ``w_embed`` over
``data``), the encoder's whole sequence brought in for its K/V.

Held as ``test_torch_tp_llama.py`` holds its step; the bounds against
the port's own step run shard by shard are 1.5x the largest CPU
readings: loss 5.6e-6 and gradients 1.07e-2 relative L2 (the encoder's
``wk``).  Against the JAX package's mesh step the worst leaf reads
1.07e-2, its ``shards`` function 1.09e-2.  The launcher trains 2 steps
under ``torch.distributed.run``.
"""
import math

import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_mesh_train_cases as mc
import torch_tp_cases as tc
from torch_threads import _one_torch_thread  # noqa: F401

ARCH = "seamless-m4t-medium-smoke"
STEP_LOSS, STEP_GRAD = 8.4e-6, 1.6e-2


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


def test_launcher_on_a_mesh(tmp_path):
    """``launch/train.py --mesh 2,2`` on the enc-dec: 2 search steps
    with finite losses, rank 0 printing."""
    run = tc.run_launcher(ARCH, "2,2", tmp_path)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert "mesh {'data': 2, 'model': 2}" in run.stdout
    done = [line for line in run.stdout.splitlines()
            if line.startswith("[train] done: losses")]
    assert len(done) == 1, run.stdout
    losses = [float(v) for v in done[0].split("[")[-1].rstrip("]").split(",")]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
