"""Tensor parallelism, FSDP and the split sequence in the search train
step (``launch/steps.make_train_step`` under ``distributed.sharding
.use_mesh`` with the reference's rules: the arch's ``RULE_OVERRIDES``
and the train shape's) for ``llama3.2-1b-smoke`` on a (2, 2) mesh of
spawned gloo CPU ranks: ``wq`` / ``w_gate`` / ``w_up`` split by column
and ``wo`` / ``w_down`` by row over ``model``, every weight's
``w_embed`` over ``data``, the vocab-parallel embedding, head and cross
entropy, the residual stream's rows over ``model`` between layers
(``torch_mesh_train_cases``, layout ``FULL``; the (1, 4) mesh is
``test_torch_tp_llama_1x4.py``).

Held, with their bounds and why:

* every parameter and optimizer-state leaf on every rank has the shard
  shape the JAX package's ``NamedSharding`` gives its logical axes on
  the same mesh shape;
* against the port's own step run shard by shard on one process (each
  data shard's rows alone, then their mean): the loss within
  ``STEP_LOSS`` relative and every gradient leaf within ``STEP_GRAD``
  relative L2, 1.5x the largest CPU readings (1.42e-5 and 1.32e-2 at
  (2, 2), 7.2e-6 and 1.27e-2 at (1, 4)): a row-parallel product sums
  its ranks' partial products in another order, so the loss is not
  held bitwise;
* against the JAX package's step on the same mesh shape
  (``torch_mesh_train_jax.py``): the single-device step's bounds (loss
  rtol 1e-4, gradients 3e-2 relative L2 per leaf;
  ``tests/test_torch_moe_train.py``), the same placements summing the
  same partial products; against its ``shards`` function: those bounds
  widened by 1.5x the JAX package's own spread between its mesh step and
  its ``shards`` function, each gradient leaf by its own leaf's spread;
  the parameters moved as the reference's, every gamma moved;
* every leaf the same on the ranks that hold the same shard of it;
* the state gathered and saved whole restores bitwise under (1, 1) and
  (1, 4); ``adam_int8``'s update of the shards (a row split over
  ``model`` takes its scale over the ranks that hold it) bitwise the
  whole tree's;
* ``launch/train.py --mesh 2,2 --device cpu --dist-backend gloo`` under
  ``torch.distributed.run`` trains 2 steps and checkpoints.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_mesh_train_cases as mc
import torch_tp_cases as tc
from repro_torch.checkpoint.checkpoint import CheckpointManager
from torch_threads import _one_torch_thread  # noqa: F401

ARCH = "llama3.2-1b-smoke"
STEP_LOSS, STEP_GRAD = 2.2e-5, 2.0e-2


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
    """Four gloo ranks under ``torch.distributed.run``: 2 steps of the
    search at (2, 2), rank 0 printing, then a whole checkpoint."""
    run = tc.run_launcher(ARCH, "2,2", tmp_path)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert run.stdout.count("[train] done") == 1, run.stdout
    assert "mesh {'data': 2, 'model': 2}" in run.stdout
    assert CheckpointManager(str(tmp_path)).peek_meta(1)["step"] == 1
