"""What ``tests/test_torch_mesh_train.py`` and
``tests/test_torch_mesh_train_scout.py`` share: one search train step of
an MoE smoke arch on a (2, 2) mesh of spawned gloo ranks, beside the JAX
package's step on a (2, 2) CPU mesh and the same function run shard by
shard with no mesh (``torch_mesh_train_jax.py``, a subprocess started
beside the ranks), and beside the port's step run shard by shard.

Both start from the port's seed-0 ``init_params(mps_on=True)`` tree as
numpy, float32 masters, the arch's optimizer at ``LR`` and
``train_microbatches`` 2 (``dataclasses.replace``; the smoke config has
1, and two micro-batches hold the row order: the global batch is split
into micro-batches first, then each micro-batch's rows over ``data``).
This module imports no JAX: the ranks import it.
"""
import dataclasses
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
MESH = (2, 2)


def tree(arch):
    """The port's seed-0 ``init_params(mps_on=True)`` draw as numpy."""
    return tree_to_numpy(tlm.init_params(
        treg.get(arch), torch.Generator().manual_seed(0), device="cpu",
        mps_on=True))


def step_cfg(cfg):
    return dataclasses.replace(cfg, train_microbatches=2)


def rules(arch):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    out = dict(treg.RULE_OVERRIDES.get(arch.replace("-smoke", ""), {}))
    out.update(steps.shape_rules(ShapeConfig("train", "train", SEQ - 1, B)))
    return out


class _Capturing:
    """An optimizer that runs ``inner`` and keeps the gradients it was
    handed (after the clip) in its state."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return {"inner": self.inner.init(params), "grads": None}

    def update(self, grads, state, params, step):
        p, s = self.inner.update(grads, state["inner"], params, step)
        return p, {"inner": s, "grads": grads}


def _rank(rank, world, arch, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        out = _rank_step(arch, out_dir)
        torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _digest(t):
    bits = t.detach().contiguous().view(
        {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
            t.element_size()]).reshape(-1).to(torch.int64)
    w = torch.arange(bits.numel()) % 8191 + 1
    return torch.stack([bits.sum(), (bits * w).sum()])


def _rank_step(arch, out_dir):
    """One search step on this rank; the gathered trees, whether every
    replicated leaf (and every bank shard across the data ranks) is the
    same on all ranks, then the checkpoint: rank 0 saves the gathered
    state, and every rank restores it under (1, 4) into its shard."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import steps
    from repro_torch.launch import train
    from repro_torch.optim import optimizers

    cfg = step_cfg(treg.get(arch))
    mesh = meshlib.make_debug_mesh(*MESH, device="cpu")
    logical = tlm.logical_axes(cfg, mps_on=True)
    opt = _Capturing(optimizers.make_optimizer(cfg.optimizer, LR))
    batch = synthetic.lm_batch(cfg.vocab, SEQ, B, 0)
    with sharding.use_mesh(mesh, rules(arch)):
        params = lm_shard_from_jax(tree(arch), cfg)
        step = steps.make_train_step(cfg, opt, search=True)
        new, st, loss = step(params, opt.init(params), batch, 0)
        out = {"coords": mesh.coords, "loss": float(loss),
               "norm": float(step.grad_norm)}
        # every rank's digest of every leaf; replicated ones must agree
        # everywhere, a bank shard across the data ranks
        same = []
        for name, t in (("p", new), ("g", st["grads"])):
            for key, leaf in flat_t(t).items():
                dg = _digest(leaf)
                parts = [torch.empty_like(dg) for _ in range(4)]
                dist.all_gather(parts, dg)
                split = "/ffn/w_" in key and key.endswith("/w") and \
                    "shared" not in key
                peers = [r for r in range(4) if not split or
                         r % MESH[1] == mesh.coords["model"]]
                same.append(all(torch.equal(parts[r], dg) for r in peers))
        out["replicated_same"] = all(same)
        out["grads"] = flat(steps.gather_tree(st["grads"], logical))
        out["params"] = flat(steps.gather_tree(new, logical))
        state = {"params": new, "opt": st["inner"]}
        slog = {"params": logical, "opt": optimizers.state_logical_axes(
            cfg.optimizer, logical)}
        whole = train.gather_state(state, slog)
        ckpt = os.path.join(out_dir, "ckpt")
        if mesh.rank == 0:
            CheckpointManager(ckpt).save(0, whole)
            torch.save(whole, os.path.join(out_dir, "whole.pt"))
        dist.barrier()
    mesh4 = meshlib.make_debug_mesh(1, 4, device="cpu")
    with sharding.use_mesh(mesh4, rules(arch)):
        want = steps.shard_tree(whole, slog)
        got, meta = train.restore_sharded(CheckpointManager(ckpt), want,
                                          slog)
        out["restored_14"] = meta["step"] == 0 and all(
            torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
        out["shard_14"] = tuple(
            got["params"]["blocks"]["l0"]["ffn"]["w_gate"]["w"].shape)
    return out


def flat_t(tree_, prefix=""):
    if isinstance(tree_, dict):
        out = {}
        for k, v in tree_.items():
            out.update(flat_t(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree_}


def leaves(tree_):
    return list(flat_t(tree_).values())


def shard_reference(arch):
    """The port's step on one process, each data shard's rows alone
    (micro-batch ``i`` of shard ``d`` is global row ``i * B / k + d``),
    the shards' gradients averaged and clipped by their global norm:
    ``(shard losses, clipped gradients)``."""
    from repro_torch.core import mps
    from repro_torch.data import synthetic
    from repro_torch.optim import grad as gradlib
    from repro_torch.optim import optimizers

    cfg = step_cfg(treg.get(arch))
    k, dp = cfg.train_microbatches, MESH[0]
    params = lm_params_from_jax(tree(arch), cfg=cfg)
    ctx = mps.SearchCtx(tau=1.0)
    batch = synthetic.lm_batch(cfg.vocab, SEQ, B, 0)
    micro = {x: v.reshape((k, B // k) + v.shape[1:]) for x, v in
             batch.items()}
    n = B // k // dp
    grads, losses = [], []
    for d in range(dp):
        g, loss = gradlib.accumulate_grads(
            lambda p, b: tlm.loss_fn(cfg, p, b, ctx=ctx, lam=1e-9), params,
            {x: v[:, d * n:(d + 1) * n] for x, v in micro.items()})
        grads.append(g)
        losses.append(float(loss))
    mean = optimizers.tree_map(lambda *gs: (sum(x.float() for x in gs) / dp)
                               .to(gs[0].dtype), *grads)
    return losses, flat(gradlib.clip_by_global_norm(mean, 1.0)[0])


def mesh_world(arch):
    """The port's (2, 2) ranks and the JAX subprocess, for one arch."""
    tmp = tempfile.mkdtemp()
    jax_out = os.path.join(tmp, "jax.npz")
    env = {**os.environ, "XLA_FLAGS":
           "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join(
               [str(HERE), str(HERE.parent / "src"),
                os.environ.get("PYTHONPATH", "")])}
    jax_proc = subprocess.Popen(
        [sys.executable, str(HERE / "torch_mesh_train_jax.py"), jax_out,
         arch], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    mp.spawn(_rank, args=(4, arch, f"file://{tmp}/rdv", tmp), nprocs=4)
    ranks = [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False)
             for r in range(4)]
    log, _ = jax_proc.communicate()
    assert jax_proc.returncode == 0, log[-3000:]
    with np.load(jax_out) as z:
        jax_res = {k: z[k] for k in z.files}
    return {"arch": arch, "ranks": ranks, "jax": jax_res, "dir": tmp,
            "tree": tree(arch), "reference": shard_reference(arch)}


# the single-device step's bounds (tests/test_torch_moe_train.py)
LOSS_RTOL, GRAD_MAX = 1e-4, 3e-2
# the (2, 2) step's gradients against the same port step run shard by
# shard on one process: 1.5x the largest reading (8.0e-3, arctic)
STEP_GRAD = 1.2e-2


def jax_spread(w):
    """The JAX package's own spread between its (2, 2) mesh step and the
    same function with no mesh (its step run on each data shard alone,
    ``shards``): the loss's and the norm's relative gaps and the
    largest leaf's relative L2 gradient gap."""
    j, a = w["jax"], w["arch"]
    grads = [k.split("|")[-1] for k in j if k.startswith(f"{a}|shards|g/")]
    return dict(
        loss=abs(float(j[f"{a}|2,2|loss"]) / float(j[f"{a}|shards|loss"])
                 - 1),
        norm=abs(float(j[f"{a}|2,2|norm"]) / float(j[f"{a}|shards|norm"])
                 - 1),
        grad=max(rel(j[f"{a}|2,2|{k}"], j[f"{a}|shards|{k}"])
                 for k in grads))


def check_step(w):
    """The (2, 2) step: (a) against the same port step run shard by
    shard on one process: every rank's step-0 loss the mean of the
    shards' losses bit for bit, every gradient leaf within
    ``STEP_GRAD``; (b) against the JAX package's same function with no
    mesh (``shards``): loss, norm and gradients within the single-device
    step's bounds (``LOSS_RTOL``, ``GRAD_MAX``); (c) against the JAX
    package's (2, 2) mesh step: within those bounds widened by 1.5x the
    JAX package's own spread between (c) and (b).  The parameters moved
    as (b)'s (Adam's first step: where its gradient is a quarter of its
    leaf's largest or more, the same way, never the other, at most 1%
    staying put) and every gamma moved.  Returns the readings."""
    j, a = w["jax"], w["arch"]
    spread = jax_spread(w)
    r0 = w["ranks"][0]
    assert all(r["loss"] == r0["loss"] and r["norm"] == r0["norm"]
               for r in w["ranks"])
    losses, ref = w["reference"]
    assert r0["loss"] == np.float32(sum(losses) / len(losses)) or \
        r0["loss"] == (losses[0] + losses[1]) / 2, (r0["loss"], losses)
    own = {k: rel(v, ref[k]) for k, v in r0["grads"].items()}
    assert max(own.values()) <= STEP_GRAD, max(own.items(),
                                               key=lambda kv: kv[1])
    out = {"own": max(own.values()), "spread": spread}
    for run, widen in (("shards", 0.0), ("2,2", 1.5)):
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
        assert gaps[worst] <= GRAD_MAX + widen * spread["grad"], (
            run, worst, gaps[worst], spread)
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
