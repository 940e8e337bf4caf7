"""The search train step under the expert-parallel layout on a (2, 2)
mesh of spawned gloo CPU ranks (``launch/steps.make_train_step`` under
``distributed.sharding.use_mesh`` with the rule overrides that unmap
every axis but ``batch`` and ``experts``, ``torch_ep_cases.EP_RULES``;
the full layout is ``tests/test_torch_tp_arctic.py``), for
``arctic-480b-smoke`` (2
super-blocks, 4 experts top-2 and the shared FFN), against the JAX
package's ``make_train_step(search=True)`` jitted on a (2, 2) CPU mesh
(``torch_mesh_train_cases``; scout's is
``test_torch_mesh_train_scout.py``); and the launcher and checkpoints
under a mesh.

Held, with their bounds and why:

* the loss, the global gradient norm and every (clipped) gradient leaf
  against the JAX package's step run shard by shard with no mesh (its
  ``shards`` function: each data shard's rows alone, then their mean)
  within the single-device step's bounds
  (``tests/test_torch_moe_train.py``: loss rtol 1e-4, gradients 3e-2
  relative L2), and against the JAX (2, 2) mesh step within those bounds
  widened by 1.5x the JAX package's own spread between its (2, 2) mesh
  step and its ``shards`` function (``torch_mesh_train_cases.check_step``
  and ``jax_spread``).  The (1, 1) vs (2, 2) spread is no yardstick: at
  two data shards each routes with its own capacity, another function.
  The parameters moved as the reference's and every gamma moved;
* every replicated leaf (and each bank shard across the data ranks that
  share it) the same on all four ranks after the step;
* the checkpoint: the (2, 2) state gathered, saved whole by rank 0 and
  restored bitwise under (1, 1) (in this process) and (1, 4) (each rank
  its shard);
* ``launch/train.py --mesh 2,2 --device cpu --dist-backend gloo`` under
  ``torch.distributed.run`` trains 2 steps and checkpoints; ``nccl`` on
  the CPU is refused, naming gloo.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_mesh_train_cases as mc
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.launch import train as ttrain
from torch_threads import _one_torch_thread  # noqa: F401

ARCTIC = "arctic-480b-smoke"


@pytest.fixture(scope="module")
def world():
    return mc.mesh_world(ARCTIC)


def test_step_matches_the_jax_mesh_step(world):
    mc.check_step(world)


def test_replicated_leaves_agree_on_every_rank(world):
    assert all(r["replicated_same"] for r in world["ranks"])
    assert [r["coords"] for r in world["ranks"]] == [
        {"data": d, "model": m} for d in range(2) for m in range(2)]


def test_checkpoint_restores_under_other_meshes(world):
    """Restored under (1, 4) on every rank (4 experts: 1 a rank), and
    under (1, 1) here, bitwise to the gathered state."""
    assert all(r["restored_other"] and r["other_shapes"][
        "blocks/l0/ffn/w_gate/w"][1] == 1 for r in world["ranks"])
    whole = torch.load(os.path.join(world["dir"], "whole.pt"),
                       weights_only=False)
    template = ttrain.steps_lib.tree_map_axes(
        lambda _, t: torch.empty_like(t), _axes_like(whole), whole)
    got, meta = CheckpointManager(os.path.join(
        world["dir"], "ckpt")).restore_latest(template)
    assert meta["step"] == 0
    for a, b in zip(mc.leaves(got), mc.leaves(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert whole["params"]["blocks"]["l0"]["ffn"]["w_gate"]["w"].shape[1] \
        == 4


def _axes_like(tree):
    if isinstance(tree, dict):
        return {k: _axes_like(v) for k, v in tree.items()}
    return ()


def test_launcher_on_a_mesh(tmp_path):
    """Four gloo ranks under ``torch.distributed.run``: 2 steps of
    arctic-smoke's search at (2, 2), rank 0 printing, then a whole
    checkpoint of 4-expert banks."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(mc.HERE.parent / "src"), os.environ.get("PYTHONPATH", "")]),
        "OMP_NUM_THREADS": "1"}
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--dist-backend", "gloo", "--arch", ARCTIC,
         "--search", "--mesh", "2,2", "--steps", "2", "--ckpt-dir",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert run.stdout.count("[train] done") == 1, run.stdout
    assert "mesh {'data': 2, 'model': 2}" in run.stdout
    meta = CheckpointManager(str(tmp_path)).peek_meta(1)
    assert meta["step"] == 1


def test_nccl_on_the_cpu_is_refused():
    with pytest.raises(SystemExit, match="gloo"):
        ttrain.main(["--device", "cpu", "--dist-backend", "nccl", "--mesh",
                     "2,2", "--steps", "1"])
