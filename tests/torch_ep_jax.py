"""The JAX package's MoE layer on a four-device CPU mesh, for
``tests/test_torch_expert_parallel.py``:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_ep_jax.py OUT.npz

For every case of ``torch_ep_cases`` (arch x weight dtype) it runs
``repro.nn.blocks.moe_layer`` under the search context (tau 1, the
reference's effective-weight hook), jitted forward + ``jax.vjp`` with the
case's cotangent: with no mesh (the single-device branch) on the whole
batch (``single1``) and on each of its two halves (``single2``: outputs
and input gradients joined, parameter gradients summed), and under
``sharding.use_mesh`` on each mesh of ``torch_ep_cases.MESHES`` (the
``shard_map`` branch).  The mesh is built here with ``Auto`` axes:
the JAX package's ``make_debug_mesh`` builds ``Explicit`` ones under JAX
0.9, which its ``with_sharding_constraint`` in the shared FFN refuses.
Writes ``{arch|dtype|where|leaf: array}`` (``where``: ``single1``,
``single2`` or ``D,M``; leaves ``y``, ``x`` (its gradient) and the parameter gradients).
JAX must see four devices before it is imported, hence a process of its
own.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType

import torch_ep_cases as ec
from repro.configs import registry as jreg
from repro.core import mps as jmps
from repro.distributed import sharding as jsh
from repro.models import lm as jlm
from repro.nn import blocks as jblocks


def _run(cfg, p, x, ct):
    getw = jlm._make_effective_w(jmps.SearchCtx(tau=1.0), cfg.mps_precisions)

    def f(pp, xx):
        return jblocks.moe_layer(pp, xx, cfg, effective_w=getw)

    def fwd_bwd(pp, xx, cc):
        y, vjp = jax.vjp(f, pp, xx)
        gp, gx = vjp(cc.astype(y.dtype))
        return y, gp, gx

    y, gp, gx = jax.jit(fwd_bwd)(p, x, ct)
    out = {"y": y, "x": gx}
    out.update({f"p/{k}": v for k, v in ec.flat(
        jax.tree.map(lambda a: np.asarray(a, np.float32), gp)).items()})
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def main(path):
    assert len(jax.devices()) >= 4, jax.devices()
    res = {}
    for arch in ec.SLOT:
        cfg = jreg.get(arch)
        for dtype in ec.DTYPES:
            ffn, x, ct = ec.case(arch, dtype)
            p = jax.tree.map(jnp.asarray, ffn)
            xb = jnp.asarray(x).astype(jnp.bfloat16)
            runs = {"single1": _run(cfg, p, xb, jnp.asarray(ct))}
            h = ec.B // 2
            halves = [_run(cfg, p, xb[i:i + h], jnp.asarray(ct[i:i + h]))
                      for i in (0, h)]
            runs["single2"] = {
                k: (np.concatenate([a[k] for a in halves]) if k in ("y", "x")
                    else (halves[0][k].astype(np.float64)
                          + halves[1][k]).astype(np.float32))
                for k in halves[0]}
            for d, m in ec.MESHES:
                mesh = jax.make_mesh((d, m), ("data", "model"),
                                     devices=jax.devices()[:d * m],
                                     axis_types=(AxisType.Auto,) * 2)
                with jsh.use_mesh(mesh):
                    runs[f"{d},{m}"] = _run(cfg, p, xb, jnp.asarray(ct))
            for where, r in runs.items():
                for k, v in r.items():
                    res[f"{arch}|{dtype}|{where}|{k}"] = v
    np.savez(path, **res)


if __name__ == "__main__":
    main(sys.argv[1])
