"""The JAX package's search train step on a four-device CPU mesh, for
the mesh training suites (``torch_mesh_train_cases.py``):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_mesh_train_jax.py OUT.npz ARCH [D,M [RULES]]

For the arch (smoke size, float32 masters, its optimizer at ``LR``,
``train_microbatches`` 2 through ``dataclasses.replace``) it runs one
``make_train_step(search=True)`` step:

* ``D,M`` (default ``2,2``): jitted under ``sharding.use_mesh`` (the
  arch's ``RULE_OVERRIDES``, the train shape's rules and ``RULES``, a
  JSON object of further overrides, default none) on a (D, M)
  mesh built with ``Auto`` axes, the parameters and the batch placed by
  ``resolve_shardings`` of their logical axes; its optimizer keeps the
  clipped gradients it was handed and a debug callback the global norm
  before the clip; beside it ``shape/p/<leaf>`` and ``shape/o/<leaf>``,
  the shard shape each parameter and optimizer-state leaf has under the
  mesh (``NamedSharding.shard_shape``);
* ``shards``: the same function with no mesh -- the step run on each
  of the D data shards' rows alone (micro-batch ``i`` of shard ``d`` is global
  row ``i * B / k + d``, as the mesh splits them), unclipped, then the
  shards' mean gradient clipped by its global norm (float64 here), the
  optimizer's update from it, and the shards' mean loss.

Writes ``{arch|run|leaf: array}``: ``loss``, ``norm``, ``g/<leaf>`` and
``p/<leaf>``, the new parameters.  JAX must see four devices
before it is imported, hence a process of its own.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType

import torch_train_cases as tc
from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import grad as jgrad
from repro.optim import optimizers as jopt
from torch_mesh_train_cases import B, LR, SEQ, step_cfg, tree


def _mesh_step(arch, np_tree, shape, extra):
    cfg = step_cfg(jreg.get(arch))
    mesh = jax.make_mesh(shape, ("data", "model"),
                         devices=jax.devices()[:shape[0] * shape[1]],
                         axis_types=(AxisType.Auto,) * 2)
    rules = dict(jreg.RULE_OVERRIDES.get(arch.replace("-smoke", ""), {}))
    train = jbase.ShapeConfig("train", "train", SEQ - 1, B)
    rules.update(jsteps.shape_rules(train))
    rules.update(extra)
    norms = []
    inner = jgrad.clip_by_global_norm

    def clip(g, c):
        out, norm = inner(g, c)
        jax.debug.callback(lambda v: norms.append(float(v)), norm)
        return out, norm

    jgrad.clip_by_global_norm = clip
    try:
        with jsh.use_mesh(mesh, rules):
            opt = tc._capturing(jopt.Optimizer,
                                jopt.make_optimizer(cfg.optimizer, LR))
            p = jax.device_put(
                jax.tree.map(jnp.asarray, np_tree),
                jsteps.resolve_shardings(mesh, jlm.logical_axes(cfg, True)))
            b = jax.device_put(
                jax.tree.map(jnp.asarray, tc.batch(cfg, 0, B, SEQ)[0]),
                jsteps.resolve_shardings(mesh,
                                         jsteps.batch_logical(cfg, train)))
            step = jax.jit(jsteps.make_train_step(cfg, opt, search=True))
            new, st, loss = jax.block_until_ready(
                step(p, opt.init(p), b, jnp.asarray(0)))
    finally:
        jgrad.clip_by_global_norm = inner
    out = {"loss": np.float32(loss), "norm": np.float32(norms[-1])}
    out.update({f"g/{k}": v for k, v in tc.flat(st["grads"]).items()})
    out.update({f"p/{k}": v for k, v in tc.flat(new).items()})
    with jsh.use_mesh(mesh, rules):
        logical = jlm.logical_axes(cfg, True)
        inner = jopt.make_optimizer(cfg.optimizer, LR)
        for tag, axes, tree_ in (
                ("p", logical, p),
                ("o", jopt.state_logical_axes(cfg.optimizer, logical),
                 jax.eval_shape(inner.init, p))):
            shapes = jax.tree.map(
                lambda sh, x: np.asarray(sh.shard_shape(x.shape)),
                jsteps.resolve_shardings(mesh, axes), tree_)
            out.update({f"shape/{tag}/{k}": v
                        for k, v in _flat_shapes(shapes).items()})
    return out


def _flat_shapes(tree_, prefix=""):
    if isinstance(tree_, dict):
        out = {}
        for k, v in tree_.items():
            out.update(_flat_shapes(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree_}


def _shard_steps(arch, np_tree, dp):
    cfg = step_cfg(jreg.get(arch))
    k = cfg.train_microbatches
    opt = tc._capturing(jopt.Optimizer,
                        jopt.make_optimizer(cfg.optimizer, LR))
    step = jax.jit(jsteps.make_train_step(cfg, opt, search=True,
                                          clip_norm=1e30))
    p = jax.tree.map(jnp.asarray, np_tree)
    batch = tc.batch(cfg, 0, B, SEQ)[0]
    n = B // k
    grads, losses = [], []
    for d in range(dp):
        rows = [i * n + d * (n // dp) + r for i in range(k)
                for r in range(n // dp)]
        sb = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)[rows]), batch)
        _, st, loss = step(p, opt.init(p), sb, jnp.asarray(0))
        grads.append({key: v.astype(np.float64)
                      for key, v in tc.flat(st["grads"]).items()})
        losses.append(float(loss))
    mean = {key: sum(g[key] for g in grads) / dp for key in grads[0]}
    norm = np.sqrt(sum(np.sum(v * v) for v in mean.values()))
    scale = min(1.0, 1.0 / max(norm, 1e-12))
    out = {"loss": np.float32(np.mean(losses)), "norm": np.float32(norm)}
    clipped = {key: (v * scale).astype(np.float32)
               for key, v in mean.items()}
    out.update({f"g/{key}": v for key, v in clipped.items()})
    inner = jopt.make_optimizer(cfg.optimizer, LR)
    g_tree = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(clipped["/".join(
            str(getattr(q, "key", q)) for q in path)]), p)
    new, _ = inner.update(g_tree, inner.init(p), p, jnp.asarray(0))
    out.update({f"p/{key}": v for key, v in tc.flat(new).items()})
    return out


def main(path, arch, mesh="2,2", extra="{}"):
    assert len(jax.devices()) >= 4, jax.devices()
    shape = tuple(int(v) for v in mesh.split(","))
    np_tree = tree(arch)
    res = {}
    for run, got in ((mesh, _mesh_step(arch, np_tree, shape,
                                       json.loads(extra))),
                     ("shards", _shard_steps(arch, np_tree, shape[0]))):
        for key, v in got.items():
            res[f"{arch}|{run}|{key}"] = np.asarray(v)
    np.savez(path, **res)


if __name__ == "__main__":
    main(*sys.argv[1:5])
