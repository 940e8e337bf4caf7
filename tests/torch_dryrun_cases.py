"""What the dry-run suites (``tests/test_torch_dryrun*.py``) share: each
side's view of every registry arch x ``SHAPES`` cell's
``steps.cell_artifacts`` on the 16 x 16 production mesh, as plain JSON
(leaf shapes, dtypes, placements, donated indices).  Run as a script
it writes one side's view:

    python tests/torch_dryrun_cases.py port OUT.json
    XLA_FLAGS=--xla_force_host_platform_device_count=256 \\
        python tests/torch_dryrun_cases.py jax OUT.json

The port's side stands for rank 0 of a ``fake`` process group of 256
ranks (its arguments are rank 0's shards on ``meta``; the batch is
global, the step cuts its rows); the JAX side reads each argument's
``NamedSharding.shard_shape``.  A placement is written per mesh axis:
the dimension it splits, or -1 (``Replicate``).  Either side is its own
process: the fake group is process-wide, and JAX must see 256 devices
before it is imported.
"""
import json
import os
import subprocess
import sys
import tempfile

AXES = ("data", "model")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def port_view():
    import torch

    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun, mesh as meshlib
    from repro_torch.launch import steps

    dryrun.fake_group(256)
    mesh = meshlib.make_production_mesh()
    out = {}
    for arch in registry.ARCHS:
        cfg = registry.get(arch)
        for name, shape in SHAPES.items():
            rules = dict(registry.RULE_OVERRIDES.get(arch, {}))
            rules.update(steps.shape_rules(shape))
            with sharding.use_mesh(mesh, rules):
                _, args, in_sh, out_sh, donate = steps.cell_artifacts(
                    cfg, shape, mesh, search=False)
            key = f"{arch}|{name}"
            rec = {"donate": list(donate), "args": {}, "in": {}, "out": {}}
            for i, a in enumerate(args):
                for k, t in _flat(a).items():
                    rec["args"][f"{i}/{k}"] = [list(t.shape), str(t.dtype)
                                               .replace("torch.", "")]
            for tag, sh in (("in", in_sh), ("out", out_sh)):
                for i, s in enumerate(sh):
                    for k, p in _flat(s).items():
                        rec[tag][f"{i}/{k}"] = [
                            getattr(x, "dim", -1) for x in p]
            out[key] = rec
    torch.distributed.destroy_process_group()
    return out


def jax_view():
    import jax
    import numpy as np

    from repro.configs import registry
    from repro.configs.base import SHAPES
    from repro.distributed import sharding
    from repro.launch import mesh as meshlib
    from repro.launch import steps

    mesh = meshlib.make_production_mesh()

    def place(ns):
        spec, dims = tuple(ns.spec), []
        for ax in AXES:
            hit = [d for d, e in enumerate(spec)
                   if e == ax or (isinstance(e, tuple) and ax in e)]
            dims.append(hit[0] if hit else -1)
        return dims

    out = {}
    for arch in registry.ARCHS:
        cfg = registry.get(arch)
        for name, shape in SHAPES.items():
            rules = dict(registry.RULE_OVERRIDES.get(arch, {}))
            rules.update(steps.shape_rules(shape))
            with sharding.use_mesh(mesh, rules):
                _, args, in_sh, out_sh, donate = steps.cell_artifacts(
                    cfg, shape, mesh, search=False)
            rec = {"donate": list(donate), "args": {}, "in": {}, "out": {},
                   "global": {}}
            for i, (a, s) in enumerate(zip(args, in_sh)):
                fa, fs = _flat(a), _flat(s)
                for k, t in fa.items():
                    rec["args"][f"{i}/{k}"] = [
                        [int(x) for x in fs[k].shard_shape(t.shape)],
                        str(np.dtype(t.dtype))]
                    rec["global"][f"{i}/{k}"] = [int(x) for x in t.shape]
            for tag, sh in (("in", in_sh), ("out", out_sh)):
                for i, s in enumerate(sh):
                    for k, ns in _flat(s).items():
                        rec[tag][f"{i}/{k}"] = place(ns)
            out[f"{arch}|{name}"] = rec
    return out


_PORT_FLOPS = (
    "import json, sys\n"
    "from repro_torch.launch import dryrun\n"
    "out = {}\n"
    "for a, s, b, n, srch in json.loads(sys.argv[1]):\n"
    "    rec, _ = dryrun.run_cell(a, s, search=srch, verbose=False,\n"
    "                             mesh=(2, 2), batch=b, seq=n)\n"
    "    assert rec.get('ok'), rec\n"
    "    out['|'.join(map(str, (a, s, b, n, srch)))] = rec\n"
    "print(json.dumps(out))\n")


def flops_views(cells):
    """The port's dry-run records of small cells (``[arch, shape, batch,
    seq, search]``) on a (2, 2) debug mesh over a fake group of four
    ranks, and the JAX package's ``hlo_analysis`` of the same cells
    compiled on a four-device CPU mesh (``torch_dryrun_jax.py``), each
    side a process of its own: ``(port, jax)``, keyed by
    ``"|".join(cell)``."""
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [here, os.path.join(here, "..", "src"),
         os.environ.get("PYTHONPATH", "")])}
    jax = subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_dryrun_jax.py"),
         os.path.join(tmp, "jax.json"), json.dumps(cells)],
        env={**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=4"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = subprocess.run([sys.executable, "-c", _PORT_FLOPS,
                           json.dumps(cells)], env=env, capture_output=True,
                          text=True, timeout=600)
    log, _ = jax.communicate(timeout=600)
    assert jax.returncode == 0, log[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]
    with open(os.path.join(tmp, "jax.json")) as f:
        return json.loads(port.stdout.strip().splitlines()[-1]), json.load(f)


if __name__ == "__main__":
    side, path = sys.argv[1:3]
    view = port_view() if side == "port" else jax_view()
    with open(path, "w") as f:
        json.dump(view, f)
