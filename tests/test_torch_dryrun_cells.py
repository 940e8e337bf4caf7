"""``steps.batch_struct`` and ``steps.cell_artifacts`` of every registry
arch x ``SHAPES`` cell on the 16 x 16 production mesh, against the JAX
package's (``torch_dryrun_cases.py``: each side in a process of its
own, the port as rank 0 of a fake group of 256 ranks, JAX on 256 CPU
devices).  Held exactly: the batch's global shapes and dtypes (the
reference's ``ShapeDtypeStruct``s), every other argument's shard shape
and dtype on rank 0 (JAX's ``NamedSharding.shard_shape``), every input
and output placement (the mesh dimension each axis splits) and the
donated indices."""
import json
import os
import subprocess
import sys
import tempfile

import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_dryrun_cases as dc
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES
from torch_threads import _one_torch_thread  # noqa: F401

CELLS = [f"{a}|{s}" for a in treg.ARCHS for s in SHAPES]
BATCH = {"train": 2, "prefill": 1, "decode": 1}


@pytest.fixture(scope="module")
def views():
    tmp = tempfile.mkdtemp()
    here = os.path.dirname(os.path.abspath(__file__))
    base = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [here, os.path.join(here, "..", "src"),
         os.environ.get("PYTHONPATH", "")])}
    procs = {side: subprocess.Popen(
        [sys.executable, dc.__file__, side, os.path.join(tmp, side)],
        env={**base, **({"XLA_FLAGS":
                         "--xla_force_host_platform_device_count=256"}
                        if side == "jax" else {})},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for side in ("port", "jax")}
    out = {}
    for side, p in procs.items():
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-3000:]
        with open(os.path.join(tmp, side)) as f:
            out[side] = json.load(f)
    return out


def _kind(cell):
    return SHAPES[cell.split("|")[1]].kind


@pytest.mark.parametrize("cell", CELLS)
def test_batch_struct_is_the_references(views, cell):
    port, jax = views["port"][cell], views["jax"][cell]
    i = BATCH[_kind(cell)]
    got = {k: v for k, v in port["args"].items() if k.startswith(f"{i}/")}
    want = {k: [jax["global"][k], v[1]] for k, v in jax["args"].items()
            if k.startswith(f"{i}/")}
    assert got and got == want


@pytest.mark.parametrize("cell", CELLS)
def test_cell_artifacts_are_the_references(views, cell):
    port, jax = views["port"][cell], views["jax"][cell]
    i = BATCH[_kind(cell)]
    assert port["donate"] == jax["donate"]
    assert set(port["args"]) == set(jax["args"])
    bad = {k: (v, jax["args"][k]) for k, v in port["args"].items()
           if not k.startswith(f"{i}/") and v != jax["args"][k]}
    assert not bad, sorted(bad.items())[:4]
    for tag in ("in", "out"):
        assert port[tag] == jax[tag], sorted(
            (k, port[tag].get(k), jax[tag].get(k))
            for k in set(port[tag]) | set(jax[tag])
            if port[tag].get(k) != jax[tag].get(k))[:4]
