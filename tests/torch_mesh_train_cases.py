"""What the mesh training suites share: one search train step of a
smoke arch on a mesh of four spawned gloo ranks, beside the JAX
package's step on a CPU mesh of the same shape and the same function run
shard by shard with no mesh (``torch_mesh_train_jax.py``, a subprocess
started beside the ranks), and beside the port's step run shard by
shard.

Three layouts: ``EP`` -- the ranks install the rule overrides that
unmap every axis but ``batch`` and ``experts`` (``torch_ep_cases
.EP_RULES``), the expert-parallel layout of
``tests/test_torch_mesh_train.py`` and ``..._scout.py``; ``FULL`` -- the
reference's rules as they are (the arch's ``RULE_OVERRIDES`` and the
train shape's), every mapped axis placed: FSDP, tensor parallelism and
the split sequence (``tests/test_torch_tp_*.py``); ``TP`` -- those rules
with ``w_embed`` unmapped (``NO_FSDP``): tensor parallelism and the
split sequence without FSDP.  The JAX package runs its full rules under
``EP`` and ``FULL``, and ``NO_FSDP`` on top of them under ``TP``.

Every case starts from the port's seed-0 ``init_params(mps_on=True)``
tree as numpy, float32 masters, the arch's optimizer at ``LR`` and
``train_microbatches`` 2 (``dataclasses.replace``; the smoke config has
1, and two micro-batches hold the row order: the global batch is split
into micro-batches first, then each micro-batch's rows over ``data``).
The batch (:func:`batch`) is ``steps.batch_struct``'s: ``lm_batch``'s
tokens and targets, a stub frontend's ``embeddings`` (and an enc-dec's
``enc_embeddings``) in place of the tokens, drawn with numpy.
This module imports no JAX: the ranks import it.
"""
import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_ep_cases as ec
from repro_torch.bridge import (lm_params_from_jax, lm_shard_from_jax,
                                tree_to_numpy)
from repro_torch.configs import registry as treg
from repro_torch.models import lm as tlm

flat, rel = ec.flat, ec.rel

HERE = pathlib.Path(__file__).resolve().parent
LR, B, SEQ = 3e-4, 4, 33
EP, FULL, TP = "ep", "full", "tp"
# the override of layout TP, on both sides
NO_FSDP = {"w_embed": None}
# the mesh a state saved under one mesh is restored under
OTHER = {(2, 2): (1, 4), (1, 4): (2, 2)}


def tree(arch):
    """The port's seed-0 ``init_params(mps_on=True)`` draw as numpy."""
    return tree_to_numpy(tlm.init_params(
        treg.get(arch), torch.Generator().manual_seed(0), device="cpu",
        mps_on=True))


def step_cfg(cfg):
    return dataclasses.replace(cfg, train_microbatches=2)


def batch(cfg):
    """The step's global batch as numpy, the keys of
    ``steps.batch_struct``: ``lm_batch``'s targets, and its tokens or a
    stub frontend's ``embeddings`` (B, SEQ - 1, D) float32 drawn from
    seed 1, with an enc-dec's ``enc_embeddings`` of the same shape
    beside them (each package casts them to bf16)."""
    from repro_torch.data import synthetic
    out = {k: v.numpy() for k, v in
           synthetic.lm_batch(cfg.vocab, SEQ, B, 0).items()}
    if cfg.frontend != "none":
        rng = np.random.default_rng(1)
        del out["tokens"]
        keys = ("embeddings", "enc_embeddings") if cfg.is_encdec else \
            ("embeddings",)
        for k in keys:
            out[k] = rng.standard_normal(
                (B, SEQ - 1, cfg.d_model)).astype(np.float32)
    return out


def torch_batch(cfg):
    return {k: torch.from_numpy(v) for k, v in batch(cfg).items()}


def rules(arch, layout=FULL):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    out = dict(treg.RULE_OVERRIDES.get(arch.replace("-smoke", ""), {}))
    out.update(steps.shape_rules(ShapeConfig("train", "train", SEQ - 1, B)))
    if layout == EP:
        out.update(ec.EP_RULES)
    elif layout == TP:
        out.update(NO_FSDP)
    return out


def label(mesh):
    return f"{mesh[0]},{mesh[1]}"


class _Capturing:
    """An optimizer that runs ``inner`` and keeps the gradients it was
    handed (after the clip) in its state."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return {"inner": self.inner.init(params), "grads": None}

    def update(self, grads, state, params, step, axes=None):
        p, s = self.inner.update(grads, state["inner"], params, step, axes)
        return p, {"inner": s, "grads": grads}


@contextlib.contextmanager
def routes():
    """Every MoE routing of the block, in call order: each call's
    ``(E, C)`` table of the tokens each expert keeps
    (``nn.blocks.moe_route``'s ``top_i``), as numpy."""
    from repro_torch.nn import blocks
    inner, got = blocks.moe_route, []

    def recorded(*args, **kw):
        out = inner(*args, **kw)
        got.append(out[3].detach().numpy().copy())
        return out

    blocks.moe_route = recorded
    try:
        yield got
    finally:
        blocks.moe_route = inner


def rerouted(a, b) -> int:
    """How many (expert, token) assignments of one routing table are not
    in the other's (an expert keeps a token or not)."""
    return sum(len(set(x.tolist()) - set(y.tolist())) for x, y in zip(a, b))


def _rank(rank, world, arch, mesh, layout, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        out = _rank_step(arch, mesh, layout, out_dir)
        torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _digest(t):
    bits = t.detach().contiguous().view(
        {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
            t.element_size()]).reshape(-1).to(torch.int64)
    w = torch.arange(bits.numel()) % 8191 + 1
    return torch.stack([bits.sum(), (bits * w).sum()])


def _rank_step(arch, shape, layout, out_dir):
    """One search step on this rank: the shard shapes of the parameters
    and the optimizer state, the gathered trees, whether every leaf is
    the same on the ranks that hold the same shard of it, then the
    checkpoint: rank 0 saves the gathered state, and every rank restores
    it under the other mesh (``OTHER``) into its shard."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import steps
    from repro_torch.launch import train
    from repro_torch.optim import optimizers

    cfg = step_cfg(treg.get(arch))
    mesh = meshlib.make_debug_mesh(*shape, device="cpu")
    logical = tlm.logical_axes(cfg, mps_on=True)
    opt = _Capturing(optimizers.make_optimizer(cfg.optimizer, LR))
    batch = torch_batch(cfg)
    slog = {"params": logical, "opt": optimizers.state_logical_axes(
        cfg.optimizer, logical)}
    coords = [dict(zip(("data", "model"), np.unravel_index(r, shape)))
              for r in range(shape[0] * shape[1])]
    with sharding.use_mesh(mesh, rules(arch, layout)):
        params = lm_shard_from_jax(tree(arch), cfg)
        st0 = opt.init(params)
        out = {"coords": mesh.coords, "shapes": {
            **{f"p/{k}": tuple(v.shape) for k, v in flat_t(params).items()},
            **{f"o/{k}": tuple(v.shape)
               for k, v in flat_t(st0["inner"]).items()}}}
        step = steps.make_train_step(cfg, opt, search=True)
        with routes() as routed:
            new, st, loss = step(params, st0, batch, 0)
        out.update(loss=float(loss), norm=float(step.grad_norm),
                   routes=routed)
        # every rank's digest of every leaf: the ranks that share this
        # rank's coordinates on the axes that split a leaf hold its shard
        same = []
        for t in (new, st["grads"]):
            split = steps.tree_map_axes(
                lambda axes, _: {a for ax in sharding.dim_axes(*axes)
                                 for a in ax}, logical, t)
            for key, leaf in flat_t(t).items():
                dg = _digest(leaf)
                parts = [torch.empty_like(dg) for _ in coords]
                dist.all_gather(parts, dg)
                axes = _at(split, key)
                peers = [r for r, c in enumerate(coords)
                         if all(c[a] == mesh.coords[a] for a in axes)]
                same.append(all(torch.equal(parts[r], dg) for r in peers))
        out["replicated_same"] = all(same)
        out["int8_bitwise"] = _int8_update_bitwise(
            st["grads"], new, logical)
        out["grads"] = flat(steps.gather_tree(st["grads"], logical))
        out["params"] = flat(steps.gather_tree(new, logical))
        state = {"params": new, "opt": st["inner"]}
        whole = train.gather_state(state, slog)
        ckpt = os.path.join(out_dir, "ckpt")
        if mesh.rank == 0:
            CheckpointManager(ckpt).save(0, whole)
            torch.save(whole, os.path.join(out_dir, "whole.pt"))
        dist.barrier()
    other = meshlib.make_debug_mesh(*OTHER[shape], device="cpu")
    with sharding.use_mesh(other, rules(arch, layout)):
        want = steps.shard_tree(whole, slog)
        got, meta = train.restore_sharded(CheckpointManager(ckpt), want,
                                          slog)
        out["restored_other"] = meta["step"] == 0 and all(
            torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
        out["other_shapes"] = {k: tuple(v.shape) for k, v in
                               flat_t(got["params"]).items()}
    return out


def _int8_update_bitwise(grads, params, logical):
    """``adam_int8``'s second update of this rank's shards (handed the
    logical axes: a row split over ranks takes its scale over them)
    against the update of the gathered whole tree cut into this
    rank's shard: every new parameter and state leaf bitwise."""
    from repro_torch.launch import steps
    from repro_torch.optim import optimizers
    opt = optimizers.adam_int8(LR)
    slog = optimizers.state_logical_axes("adam_int8", logical)
    whole_g = steps.gather_tree(grads, logical)
    whole_p = steps.gather_tree(params, logical)
    whole_s = opt.update(whole_g, opt.init(whole_p), whole_p, 0)[1]
    want = opt.update(whole_g, whole_s, whole_p, 1)
    got = opt.update(grads, steps.shard_tree(whole_s, slog), params, 1,
                     logical)
    want = (steps.shard_tree(want[0], logical),
            steps.shard_tree(want[1], slog))
    return all(torch.equal(a, b) for a, b in zip(
        leaves(got[0]) + leaves(got[1]), leaves(want[0]) + leaves(want[1])))


def _at(tree_, key):
    for k in key.split("/"):
        tree_ = tree_[k]
    return tree_


def flat_t(tree_, prefix=""):
    if isinstance(tree_, dict):
        out = {}
        for k, v in tree_.items():
            out.update(flat_t(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree_}


def leaves(tree_):
    return list(flat_t(tree_).values())


def shard_reference(arch, dp):
    """The port's step on one process, each of ``dp`` data shards' rows
    alone (micro-batch ``i`` of shard ``d`` is global row ``i * B / k +
    d``), the shards' gradients averaged and clipped by their global
    norm: ``(shard losses, clipped gradients)``."""
    from repro_torch.core import mps
    from repro_torch.optim import grad as gradlib
    from repro_torch.optim import optimizers

    cfg = step_cfg(treg.get(arch))
    k = cfg.train_microbatches
    params = lm_params_from_jax(tree(arch), cfg=cfg)
    ctx = mps.SearchCtx(tau=1.0)
    batch = torch_batch(cfg)
    micro = {x: v.reshape((k, B // k) + v.shape[1:]) for x, v in
             batch.items()}
    n = B // k // dp
    grads, losses = [], []
    with routes() as routed:
        for d in range(dp):
            g, loss = gradlib.accumulate_grads(
                lambda p, b: tlm.loss_fn(cfg, p, b, ctx=ctx, lam=1e-9),
                params, {x: v[:, d * n:(d + 1) * n] for x, v in
                         micro.items()})
            grads.append(g)
            losses.append(float(loss))
    mean = optimizers.tree_map(lambda *gs: (sum(x.float() for x in gs) / dp)
                               .to(gs[0].dtype), *grads)
    return losses, flat(gradlib.clip_by_global_norm(mean, 1.0)[0]), routed


def mesh_world(arch, mesh=(2, 2), layout=EP, split_jax=False):
    """The port's ranks on ``mesh`` under ``layout`` and the JAX
    subprocess, for one arch; ``split_jax``: two JAX subprocesses at
    once, the mesh step in one and the ``shards`` function in the other
    (the hybrid's, each ~70 s of XLA compiling)."""
    tmp = tempfile.mkdtemp()
    env = {**os.environ, "XLA_FLAGS":
           "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join(
               [str(HERE), str(HERE.parent / "src"),
                os.environ.get("PYTHONPATH", "")])}
    jobs = ("mesh", "shards") if split_jax else ("mesh,shards",)
    jax_procs = [(os.path.join(tmp, f"jax{i}.npz"), subprocess.Popen(
        [sys.executable, str(HERE / "torch_mesh_train_jax.py"),
         os.path.join(tmp, f"jax{i}.npz"), arch, label(mesh),
         json.dumps(NO_FSDP if layout == TP else {}), runs],
        env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for i, runs in enumerate(jobs)]
    n = mesh[0] * mesh[1]
    mp.spawn(_rank, args=(n, arch, tuple(mesh), layout, f"file://{tmp}/rdv",
                          tmp), nprocs=n)
    ranks = [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False)
             for r in range(n)]
    jax_res = {}
    for out, proc in jax_procs:
        log, _ = proc.communicate()
        assert proc.returncode == 0, log[-3000:]
        with np.load(out) as z:
            jax_res.update({k: z[k] for k in z.files})
    return {"arch": arch, "mesh": tuple(mesh), "label": label(mesh),
            "layout": layout, "ranks": ranks, "jax": jax_res, "dir": tmp,
            "tree": tree(arch), "reference": shard_reference(arch, mesh[0])}


# the single-device step's bounds (tests/test_torch_moe_train.py)
LOSS_RTOL, GRAD_MAX = 1e-4, 3e-2
# the (2, 2) step's gradients against the same port step run shard by
# shard on one process: 1.5x the largest reading (8.0e-3, arctic)
STEP_GRAD = 1.2e-2


def jax_spread(w):
    """The JAX package's own spread between its mesh step and the same
    function with no mesh (its step run on each data shard alone,
    ``shards``): the loss's and the norm's relative gaps, each leaf's
    relative L2 gradient gap (``leaves``) and the largest (``grad``)."""
    j, a, m = w["jax"], w["arch"], w["label"]
    grads = [k.split("|")[-1] for k in j if k.startswith(f"{a}|shards|g/")]
    leaves_ = {k[2:]: rel(j[f"{a}|{m}|{k}"], j[f"{a}|shards|{k}"])
               for k in grads}
    return dict(
        loss=abs(float(j[f"{a}|{m}|loss"]) / float(j[f"{a}|shards|loss"])
                 - 1),
        norm=abs(float(j[f"{a}|{m}|norm"]) / float(j[f"{a}|shards|norm"])
                 - 1),
        grad=max(leaves_.values()), leaves=leaves_)


def _bound(step_grad, key):
    """A leaf's bound: ``step_grad`` itself, or the value of the first
    entry of a ``{substring: bound}`` dict whose substring is in the
    leaf's key (``""`` matches every leaf)."""
    if not isinstance(step_grad, dict):
        return step_grad
    return next(b for s, b in step_grad.items() if s in key)


def check_step(w, step_grad=STEP_GRAD, step_loss=0.0, jax_grad=None):
    """The mesh step: (a) against the same port step run shard by shard
    on one process: every rank's step-0 loss the mean of the shards'
    losses -- bit for bit under ``EP`` (``step_loss`` 0), within relative
    ``step_loss`` under ``FULL`` and ``TP``, whose row-parallel products
    sum their partial products across ranks in another order -- and
    every gradient leaf within ``step_grad`` (a number, or per leaf a
    ``{substring: bound}`` dict, :func:`_bound`); (b) against the JAX
    package's same function with no mesh (``shards``): loss, norm and
    gradients within the single-device step's bounds (``LOSS_RTOL``,
    ``GRAD_MAX``) under ``EP``; under ``FULL`` and ``TP``, a mesh step
    summing in another order as the JAX package's mesh step does, those
    bounds widened by 1.5x the JAX package's own spread between its mesh
    step and (b), each gradient leaf by its own leaf's; (c) against the
    JAX package's step on the same mesh shape: under ``EP`` within the
    single-device bounds widened by 1.5x that spread (the largest leaf's
    for every gradient leaf), under ``FULL`` and ``TP`` -- the same
    placements, the same sums split -- within the single-device bounds
    themselves, or per leaf within ``jax_grad`` (a ``{substring:
    bound}`` dict) where the two mesh steps route a token at an expert's
    capacity otherwise (a witness shows it).  The parameters moved as (b)'s (Adam's first step: where
    its gradient is a quarter of its leaf's largest or more, the same
    way, never the other, at most 1% staying put) and every gamma moved.
    Returns the readings."""
    j, a = w["jax"], w["arch"]
    spread = jax_spread(w)
    r0 = w["ranks"][0]
    assert all(r["loss"] == r0["loss"] and r["norm"] == r0["norm"]
               for r in w["ranks"])
    losses, ref = w["reference"][:2]
    mean = np.float32(sum(losses) / len(losses))
    if step_loss:
        assert abs(r0["loss"] / mean - 1) <= step_loss, (r0["loss"], losses)
    else:
        assert r0["loss"] == mean or \
            r0["loss"] == (losses[0] + losses[1]) / 2, (r0["loss"], losses)
    own = {k: rel(v, ref[k]) for k, v in r0["grads"].items()}
    over = {k: (v, _bound(step_grad, k)) for k, v in own.items()
            if v > _bound(step_grad, k)}
    assert not over, over
    out = {"own": max(own.values()), "own_loss": abs(r0["loss"] / mean - 1),
           "spread": spread}
    ep = w["layout"] == EP
    for run, widen in (("shards", 0.0 if ep else 1.5),
                       (w["label"], 1.5 if ep else 0.0)):
        loss_gap = abs(r0["loss"] / float(j[f"{a}|{run}|loss"]) - 1)
        norm_gap = abs(r0["norm"] / float(j[f"{a}|{run}|norm"]) - 1)
        assert loss_gap <= LOSS_RTOL + widen * spread["loss"], (
            run, loss_gap, spread)
        assert norm_gap <= GRAD_MAX + widen * spread["norm"], (
            run, norm_gap, spread)
        gaps = {k: rel(v, j[f"{a}|{run}|g/{k}"])
                for k, v in r0["grads"].items()}
        assert len(gaps) == sum(1 for k in j if k.startswith(
            f"{a}|{run}|g/"))
        worst = max(gaps, key=gaps.get)
        limit = {k: GRAD_MAX + widen * (
            spread["grad"] if ep else spread["leaves"][k]) for k in gaps}
        if jax_grad is not None and run == w["label"]:
            limit = {k: _bound(jax_grad, k) for k in gaps}
        over = {k: v for k, v in gaps.items() if v > limit[k]}
        assert not over, (run, over, spread)
        out[run] = dict(loss=loss_gap, norm=norm_gap, grad=gaps[worst],
                        worst=worst)
    start = flat(lm_params_from_jax(w["tree"]))
    held = 0
    for k, v in r0["params"].items():
        jp, jg = j[f"{a}|shards|p/{k}"], j[f"{a}|shards|g/{k}"]
        jd, td = np.sign(jp - start[k]), np.sign(v - start[k])
        big = (np.abs(jg) >= 0.25 * np.abs(jg).max()) & (jd != 0)
        assert not (td[big] == -jd[big]).any(), k
        assert (td[big] == 0).sum() <= 0.01 * big.sum(), k
        held += bool(big.any())
        if k.endswith("gamma"):
            assert not np.array_equal(v, start[k]), k
    assert held > len(r0["params"]) // 2
    return out
