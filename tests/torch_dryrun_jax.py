"""The JAX package's dry-run analysis of small cells on a four-device CPU
mesh, for ``tests/test_torch_dryrun.py``:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_dryrun_jax.py OUT.json CELLS_JSON

``CELLS_JSON`` lists ``[arch, shape, batch, seq, search]``.  For each
cell (the shape of ``SHAPES`` with the batch and sequence replaced) it
builds a (2, 2) mesh with ``Auto`` axes, installs the arch's
``RULE_OVERRIDES`` and ``steps.shape_rules``, takes
``steps.cell_artifacts``, lowers and compiles the step as
``launch/dryrun.py`` does and writes ``hlo_analysis.analyze``'s per-device
totals of the compiled HLO: ``flops`` (dots only, loop bodies weighted
by their trip counts), ``bytes``, ``dot_bytes`` and the collective
counts and bytes by kind.  JAX must see four devices before it is
imported, hence a process of its own.
"""
import dataclasses
import json
import sys

import jax
from jax.sharding import AxisType

from repro.configs import registry as jreg
from repro.configs.base import SHAPES
from repro.distributed import hlo_analysis
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps


def analyze(arch, shape_name, batch, seq, search):
    cfg = jreg.get(arch)
    shape = dataclasses.replace(SHAPES[shape_name], global_batch=batch,
                                seq_len=seq)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         devices=jax.devices()[:4],
                         axis_types=(AxisType.Auto,) * 2)
    rules = dict(jreg.RULE_OVERRIDES.get(arch.removesuffix("-smoke"), {}))
    rules.update(jsteps.shape_rules(shape))
    with jsh.use_mesh(mesh, rules):
        step, args, in_sh, out_sh, donate = jsteps.cell_artifacts(
            cfg, shape, mesh, search=search)
        compiled = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh,
                           donate_argnums=donate).lower(*args).compile()
    t = hlo_analysis.analyze(compiled.as_text())
    return {"flops": t.flops, "bytes": t.bytes, "dot_bytes": t.dot_bytes,
            "coll_bytes": t.coll_bytes, "coll_counts": t.coll_counts}


def main(path, cells):
    assert len(jax.devices()) >= 4, jax.devices()
    out = {"|".join(map(str, c)): analyze(*c) for c in json.loads(cells)}
    with open(path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
