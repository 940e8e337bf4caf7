"""What the tensor-parallel suites (``tests/test_torch_tp_*.py``) share:
the checks of one search train step under the reference's full
placements (``torch_mesh_train_cases`` with layout ``FULL``: FSDP on
``data``, tensor parallelism and the split sequence on ``model``), and
the launcher under ``torch.distributed.run``.  This module imports no
JAX."""
import os
import subprocess
import sys

import torch

import torch_mesh_train_cases as mc
from repro_torch.checkpoint.checkpoint import CheckpointManager


def check_shapes(w):
    """Every parameter and optimizer-state leaf on every rank has the
    shard shape the JAX package's ``NamedSharding`` gives its logical
    axes on the same mesh shape (``shape/p/...``, ``shape/o/...``)."""
    j, a, m = w["jax"], w["arch"], w["label"]
    want = {k.split("|shape/")[1]: tuple(int(x) for x in v)
            for k, v in j.items() if k.startswith(f"{a}|{m}|shape/")}
    assert want and any(k.startswith("o/") for k in want)
    split = 0
    for r in w["ranks"]:
        assert r["shapes"] == want, sorted(
            (k, r["shapes"].get(k), v) for k, v in want.items()
            if r["shapes"].get(k) != v)[:5]
        split += sum(1 for k, v in r["shapes"].items()
                     if k.startswith("p/") and
                     v != w["tree_shapes"].get(k[2:], v))
    assert split, "nothing split"


def check_replicated(w):
    """Every leaf is the same on the ranks that hold the same shard of
    it, after the step (parameters and gradients)."""
    assert all(r["replicated_same"] for r in w["ranks"])
    shape = w["mesh"]
    assert [r["coords"] for r in w["ranks"]] == [
        {"data": d, "model": m} for d in range(shape[0])
        for m in range(shape[1])]


def check_restore(w):
    """The state gathered, saved whole by rank 0 and restored bitwise
    under the other mesh (each rank its shard) and under (1, 1) here;
    ``adam_int8``'s update of the shards bitwise the whole's."""
    assert all(r["restored_other"] for r in w["ranks"])
    assert all(r["int8_bitwise"] for r in w["ranks"])
    whole = torch.load(os.path.join(w["dir"], "whole.pt"),
                       weights_only=False)
    template = _like(whole)
    got, meta = CheckpointManager(os.path.join(
        w["dir"], "ckpt")).restore_latest(template)
    assert meta["step"] == 0
    for a, b in zip(mc.leaves(got), mc.leaves(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for k, v in mc.flat_t(whole["params"]).items():
        assert tuple(v.shape) == w["tree_shapes"][k], k


def _like(tree):
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    return torch.empty_like(tree)


def world(arch, mesh, layout=mc.FULL, split_jax=False):
    """``mc.mesh_world`` under the full placements (or ``layout``), with
    the whole tree's leaf shapes."""
    w = mc.mesh_world(arch, mesh, layout, split_jax)
    w["tree_shapes"] = {k: tuple(v.shape)
                        for k, v in mc.flat_t(w["tree"]).items()}
    return w


def run_launcher(arch, mesh, tmp_path, steps=2):
    """``launch/train.py --mesh D,M --device cpu --dist-backend gloo``
    under ``torch.distributed.run``, four ranks: the completed process."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(mc.HERE.parent / "src"), os.environ.get("PYTHONPATH", "")]),
        "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--dist-backend", "gloo", "--arch", arch,
         "--search", "--mesh", mesh, "--steps", str(steps), "--seq", "32",
         "--ckpt-dir", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=300)
