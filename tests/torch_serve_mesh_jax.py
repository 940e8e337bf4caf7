"""The JAX package's prefill and decode steps on a four-device CPU mesh,
for the serving mesh suites (``torch_serve_mesh_cases.py``):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_serve_mesh_jax.py OUT.npz CASE_JSON

For one case (its arch at smoke size, the port's seed-0 tree as numpy,
the case's numpy inputs: ``prefill_batch`` / ``decode_batch``, a stub
frontend's embeddings where the arch has one) it runs, on a mesh of the case's shape built
with ``Auto`` axes and under the arch's ``RULE_OVERRIDES`` and
``steps.shape_rules`` of the run's shapes, the run of
``torch_serve_mesh_cases.port_run``: ``make_prefill_step`` jitted with
the reference's ``out_shardings`` (``cell_artifacts``' logits and cache
placements), the caches copied into ``S_MAX`` positions, then
``make_decode_step`` jitted with the caches donated, ``T`` steps at a
shared () position.  Writes ``prefill``, ``logits``, ``cache/<leaf>``,
``final/<leaf>`` and ``shape|shape/<prefill|decode>/<leaf>``, the shard
shape ``NamedSharding.shard_shape`` gives each cache leaf.  JAX must see
four devices before it is imported, hence a process of its own.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding

import torch_serve_mesh_cases as sc
from repro.configs import registry as jreg
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import lm as jlm


def _flat(tree_, prefix=""):
    if isinstance(tree_, dict):
        out = {}
        for k, v in tree_.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree_}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def run(case):
    cfg = jreg.get(case.arch)
    mesh = jax.make_mesh(case.mesh, ("data", "model"),
                         devices=jax.devices()[:case.mesh[0] * case.mesh[1]],
                         axis_types=(AxisType.Auto,) * 2)
    np_tree, data = sc.tree(case.arch), sc.inputs(case)
    pre, dec = sc.shapes(case)
    out = {}

    def placements(shape):
        rules = dict(jreg.RULE_OVERRIDES.get(sc.base_arch(case.arch), {}))
        rules.update(jsteps.shape_rules(shape))
        return rules

    def caches_sh():
        return jsteps.resolve_shardings(mesh, jlm.cache_logical_axes(cfg))

    def shard_shapes(tag, tree_):
        sh = caches_sh()
        for k, v in _flat(jax.tree.map(
                lambda s, x: np.asarray(s.shard_shape(x.shape)), sh,
                tree_)).items():
            out[f"shape|shape/{tag}/{k}"] = v

    with jsh.use_mesh(mesh, placements(pre or dec)):
        p = jax.device_put(
            jax.tree.map(jnp.asarray, np_tree),
            jsteps.resolve_shardings(mesh, jlm.logical_axes(cfg)))
        if case.run == "serve":
            b_sh = jsteps.resolve_shardings(mesh,
                                            jsteps.batch_logical(cfg, pre))
            batch = jax.device_put(
                jax.tree.map(jnp.asarray, sc.prefill_batch(cfg, data)), b_sh)
            logits_sh = NamedSharding(mesh, jsh.spec("batch", None, "vocab"))
            step = jax.jit(jsteps.make_prefill_step(cfg),
                           out_shardings=(logits_sh, caches_sh()))
            logits, caches = step(p, batch)
            out["prefill"] = _np(logits)
            shard_shapes("prefill", caches)
            whole = jax.tree.map(lambda x: np.asarray(x), caches)
            out.update({f"cache/{k}": _np(v)
                        for k, v in _flat(whole).items()})
            big = jlm.init_caches(cfg, case.b, case.s_max)

            def put(d, s):
                if d.ndim == 5 and d.shape[2] == case.s_max and \
                        s.shape[2] != case.s_max:
                    return d.at[:, :, :s.shape[2]].set(s)
                return jnp.asarray(s, d.dtype)
            big = jax.tree.map(put, big, whole)
        else:
            big = jlm.init_caches(cfg, case.b, case.s_max)
            flat = data["cache"]
            big = jax.tree_util.tree_map_with_path(
                lambda path, d: jnp.asarray(flat["/".join(
                    str(getattr(q, "key", q)) for q in path)], d.dtype), big)
    start = case.s if case.run == "serve" else case.s_max - case.t
    with jsh.use_mesh(mesh, placements(dec)):
        p = jax.device_put(
            p, jsteps.resolve_shardings(mesh, jlm.logical_axes(cfg)))
        caches = jax.device_put(big, caches_sh())
        shard_shapes("decode", caches)
        b_sh = jsteps.resolve_shardings(mesh, jsteps.batch_logical(cfg, dec))
        logits_sh = NamedSharding(mesh, jsh.spec("batch", None, "vocab"))
        step = jax.jit(jsteps.make_decode_step(cfg),
                       out_shardings=(logits_sh, caches_sh()),
                       donate_argnums=(2,))
        got = []
        for i in range(case.t):
            tok = jax.device_put(jax.tree.map(
                jnp.asarray, sc.decode_batch(cfg, data, i)), b_sh)
            logits, caches = step(p, tok, caches, jnp.int32(start + i))
            got.append(_np(logits))
        out["logits"] = np.stack(got)
        out.update({f"final/{k}": _np(v) for k, v in _flat(caches).items()})
    return out


def main(path, case_json):
    assert len(jax.devices()) >= 4, jax.devices()
    kw = json.loads(case_json)
    kw["mesh"] = tuple(kw["mesh"])
    np.savez(path, **run(sc.Case(**kw)))


if __name__ == "__main__":
    main(*sys.argv[1:3])
