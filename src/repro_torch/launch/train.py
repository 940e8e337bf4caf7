"""Train an LM, optionally under the paper's joint search
(``repro.launch.train``):

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch llama3.2-1b-smoke --steps 4 --search --ckpt-dir /tmp/ckpt

Runs on ``cuda`` unless ``--device`` names another device, and raises
when there is no card.  Parameters come from seed 0, the data from
``data.synthetic.lm_batch`` (a pure function of the step), the optimizer
is ``cfg.optimizer`` at 3e-4.  ``--search`` trains with the per-channel
selection logits (``init_params(mps_on=True)``, ``make_train_step(...,
search=True)``) and prints the plan ``lm.extract_plan`` takes from them.

Fault tolerance as in the reference: with ``--ckpt-dir`` a run resumes
from the newest readable checkpoint, saves every ``--ckpt-every`` steps
and at the end, and on SIGTERM saves the step it finished and exits.

``--profile N`` (CUDA) times N more steps untraced, then traces N with
``torch.profiler`` and prints the device time by kernel, K4's and K5's
(forward, backward) device ms a step, the device operations a step and
the device's busy share of the traced window.

An enc-dec stack (``--arch seamless-m4t-medium``) trains on the tokens
alone, as the reference's launcher does: with no ``enc_embeddings`` in
the batch its encoder embeds them.  Batches that carry a stub
frontend's ``embeddings`` or ``enc_embeddings`` pass through
``launch.steps`` unchanged.

A Mamba-2 stack (``--arch mamba2-780m``) or a hybrid (``--arch
jamba-1.5-large-398b``) trains on sequences that its chunk
(``ssm_chunk``, or ``--seq`` itself when shorter) tiles; another
``--seq`` exits with an error.

MoE stacks (llama4-scout, arctic) and the hybrid train on one device as
the reference's single-device branch does -- every expert local, each
bank's one gamma searched over all its experts -- or on a mesh of ranks.

The mesh: ``--mesh D,M`` (default ``1,1``, as the reference's launcher
installs it) or ``--production-mesh`` (16 x 16 ranks) under
``torch.distributed.run``, one process a rank::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --device cpu --dist-backend gloo \
        --arch arctic-480b-smoke --search --mesh 2,2 --steps 2

The launcher installs the reference's rules (the arch's
``RULE_OVERRIDES`` and the train shape's), and the port places every
axis they map (``distributed/sharding.py``): each rank takes its rows of
every batch (``batch`` on ``data``), its block of every weight's
``w_embed`` axis (FSDP on ``data``), its heads, FFN columns, vocab rows,
Mamba-2 heads and experts (tensor and expert parallelism on ``model``),
and the residual stream's rows of the sequence between layers
(``act_seq`` on ``model``); every family trains so, the enc-dec one
(its encoder, cross attention and raw cross weights placed as the
decoder's) included::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --device cpu --dist-backend gloo \
        --arch llama3.2-1b-smoke --search --mesh 2,2 --steps 2
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --device cpu --dist-backend gloo \
        --arch seamless-m4t-medium-smoke --search --mesh 2,2 --steps 2

Every rank draws the whole seed-0 tree and keeps its shard.  ``--dist-backend``: ``nccl`` by
default on ``cuda``, ``gloo`` on the CPU; NCCL takes one rank a device,
so ranks sharing a card need ``--dist-backend gloo`` (asked, never
switched to).  Rank 0 prints.  Checkpoints are mesh-agnostic: the
shards are gathered and rank 0 saves the whole tree, and a restore under
any mesh cuts it again.
"""
from __future__ import annotations

import argparse
import math
import os
import signal
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import mps
from repro_torch.distributed import sharding
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.nn import blocks
from repro_torch.optim import optimizers


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_steps(step_fn, state, batch_at, first: int, n: int, dev):
    """Run steps ``first .. first + n - 1`` from ``state`` under
    ``torch.profiler``.  Returns the new state and ``{"wall_s",
    "device_s", "launches", "kernels", "copies"}``: the window's wall
    time, the device time summed over its kernel rows, their count
    (kernels and copies), device seconds by kernel name, and K4's
    transposing copies into rows (``core.mps.COPY_RANGES``) as
    ``{range: (count, device seconds)}``."""
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in range(first, first + n):
            p, o, _ = step_fn(state["params"], state["opt"], batch_at(step),
                              step)
            state = {"params": p, "opt": o}
        _sync(dev)
        wall = time.perf_counter() - t0
    # the kernel rows only: an operator's row repeats its kernels' time,
    # and so does a profiler range's device-side row
    ranges = set(mps.COPY_RANGES.values())
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in ranges]
    kernels = {e.key: e.self_device_time_total / 1e6 for e in rows}
    copies = {}
    for e in prof.key_averages():
        if e.key in ranges:
            got = (e.count, e.device_time_total / 1e6)
            copies[e.key] = max(copies.get(e.key, got), got,
                                key=lambda c: c[1])
    return state, {"wall_s": wall, "device_s": sum(kernels.values()),
                   "launches": sum(e.count for e in rows),
                   "kernels": kernels, "copies": copies,
                   "table": prof.key_averages().table(
                       sort_by="self_device_time_total", row_limit=20)}


# the hand-written kernels of a training step, by a fragment of their
# CUDA names (ssd_scan_kernel is K5's forward only)
KERNEL_CLASSES = (("K4 forward + backward (mps_*)", "mps_"),
                  ("K5 forward (ssd_scan_kernel)", "ssd_scan_kernel"),
                  ("K5 backward (ssd_scan_bwd)", "ssd_scan_bwd"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b-smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--search", action="store_true",
                    help="joint MPS + pruning objective (paper Sec. 4)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--profile", type=int, default=0,
                    help="time and trace this many extra steps (CUDA)")
    ap.add_argument("--mesh", default="1,1",
                    help="data,model: the debug mesh's shape")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 mesh (needs 256 ranks)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="process group backend (default: nccl on cuda, "
                         "gloo on the cpu)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = registry.get(args.arch)
    owned = not dist.is_initialized()
    mesh = _make_mesh(args, dev)
    rules = dict(registry.RULE_OVERRIDES.get(cfg.name.replace("-smoke", ""),
                                             {}))
    rules.update(steps_lib.shape_rules(ShapeConfig(
        "train", "train", args.seq, args.batch)))
    try:
        with sharding.use_mesh(mesh, rules):
            return _train(args, cfg, mesh)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _make_mesh(args, dev):
    """The mesh of ``--mesh`` / ``--production-mesh``; initialises the
    process group from ``torch.distributed.run``'s environment when the
    mesh has more than one rank."""
    data, model = (int(v) for v in args.mesh.split(","))
    n = 256 if args.production_mesh else data * model
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if n > 1 or world > 1:
        backend = args.dist_backend or ("nccl" if dev.type == "cuda"
                                        else "gloo")
        if backend == "nccl":
            if dev.type != "cuda":
                raise SystemExit("--dist-backend nccl runs on cuda; the cpu "
                                 "takes gloo")
            if world > torch.cuda.device_count():
                raise SystemExit(
                    f"--dist-backend nccl takes one rank a device: {world} "
                    f"ranks on {torch.cuda.device_count()} cuda device(s); "
                    f"pass --dist-backend gloo to share them")
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            dev = torch.device("cuda", local % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        if not dist.is_initialized():
            dist.init_process_group(backend)
    if args.production_mesh:
        return meshlib.make_production_mesh(device=dev)
    return meshlib.make_debug_mesh(data, model, device=dev)


def _train(args, cfg, mesh) -> dict:
    dev = mesh.device
    lead = mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    if cfg.is_ssm or cfg.is_hybrid:
        try:
            blocks.ssm_chunk(cfg, args.seq, "train")
        except ValueError as e:
            raise SystemExit(f"--seq {args.seq}: {e}") from None
    gen = torch.Generator(device=dev).manual_seed(0)
    logical = lm.logical_axes(cfg, mps_on=args.search)
    params = steps_lib.shard_tree(
        lm.init_params(cfg, gen, dev, mps_on=args.search), logical)
    opt = optimizers.make_optimizer(cfg.optimizer, 3e-4)
    step_fn = steps_lib.make_train_step(cfg, opt, search=args.search)
    state = {"params": params, "opt": opt.init(params)}
    logical = {"params": logical,
               "opt": optimizers.state_logical_axes(cfg.optimizer, logical)}

    def batch_at(step):
        return synthetic.lm_batch(cfg.vocab, args.seq + 1, args.batch, step,
                                  device=dev)

    mgr, start = None, 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=2)
        restored, meta = restore_sharded(mgr, state, logical)
        if restored is not None:
            state, start = restored, meta["step"] + 1
            say(f"[train] resumed from step {meta['step']}", flush=True)

    def save(step, blocking=True):
        whole = gather_state(state, logical)
        if lead:
            mgr.save(step, whole, blocking=blocking)

    stop = {"flag": False}
    prev = signal.signal(signal.SIGTERM, lambda *_: stop.update(flag=True))
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say(f"[train] {cfg.name} on {where}: steps {start}..{args.steps - 1}, "
        f"batch {args.batch} x seq {args.seq}, search {args.search}, mesh "
        f"{mesh.shape}", flush=True)
    losses = []
    t0 = time.perf_counter()
    try:
        for step in range(start, args.steps):
            p, o, loss = step_fn(state["params"], state["opt"], batch_at(step),
                                 step)
            state = {"params": p, "opt": o}
            losses.append(float(loss))
            say(f"[train] step {step} loss {losses[-1]:.4f} grad norm "
                f"{float(step_fn.grad_norm):.4f} "
                f"({time.perf_counter() - t0:.1f}s)", flush=True)
            if dist.is_initialized():     # every rank stops at one step
                flag = torch.tensor([float(stop["flag"])], device=dev)
                stop["flag"] = bool(sharding.all_reduce_max(
                    flag, dist.group.WORLD).item())
            if mgr and (step % args.ckpt_every == 0 and step > start
                        or stop["flag"]):
                save(step, blocking=stop["flag"])
            if stop["flag"]:
                say("[train] SIGTERM: checkpointed, exiting", flush=True)
                sys.exit(0)
        if mgr:
            mgr.wait()
            save(args.steps - 1)
    finally:
        signal.signal(signal.SIGTERM, prev)
    say(f"[train] done: losses {[round(v, 4) for v in losses]}",
        flush=True)
    if args.search:
        say(f"[train] {lm.extract_plan(cfg, state['params']).summary()}",
            flush=True)
    if args.profile:
        if dev.type != "cuda" or math.prod(mesh.shape.values()) > 1:
            raise RuntimeError("--profile times the card, one rank on cuda")
        t0 = time.perf_counter()
        for step in range(args.steps, args.steps + args.profile):
            p, o, _ = step_fn(state["params"], state["opt"], batch_at(step),
                              step)
            state = {"params": p, "opt": o}
        _sync(dev)
        untraced = time.perf_counter() - t0
        state, prof = profile_steps(step_fn, state, batch_at,
                                    args.steps + args.profile, args.profile,
                                    dev)
        print(prof["table"])
        n = args.profile
        for label, key in KERNEL_CLASSES:
            ms = 1e3 * sum(v for k, v in prof["kernels"].items()
                           if key in k) / n
            print(f"[profile] {label}: {ms:.3f} device ms a step", flush=True)
        print(f"[profile] untraced: {n} steps in {untraced:.3f} s = "
              f"{1e3 * untraced / n:.1f} ms a step; traced: {n} steps in "
              f"{prof['wall_s']:.3f} s, {prof['launches']} device operations "
              f"(kernels, copies) = {prof['launches'] / n:.0f} a step; device "
              f"busy {prof['device_s']:.3f} s = "
              f"{100 * prof['device_s'] / prof['wall_s']:.1f}% of the window "
              f"(kernel time summed; the profiler slows the host)")
    return {"state": state, "losses": losses, "start": start}


def gather_state(state, logical):
    """The whole training state from every rank's shard (a collective);
    with one rank, the state itself."""
    mesh = sharding.get_mesh()
    if mesh is None or math.prod(mesh.shape.values()) == 1:
        return state
    return steps_lib.gather_tree(state, logical)


def restore_sharded(mgr, state, logical):
    """The newest checkpoint (a whole tree, written under any mesh) cut
    into this rank's shard: ``(state, meta)`` or ``(None, None)``.  Every
    rank reads the file; the template is the whole tree's shapes."""
    mesh = sharding.get_mesh()
    if mesh is None or math.prod(mesh.shape.values()) == 1:
        return mgr.restore_latest(state)
    template = steps_lib.tree_map_axes(
        lambda axes, leaf: _whole_like(axes, leaf, mesh), logical, state)
    whole, meta = mgr.restore_latest(template)
    if whole is None:
        return None, None
    shard = steps_lib.shard_tree(whole, logical)
    return steps_lib.tree_map_axes(lambda _, t, like: t.to(like.device),
                                   logical, shard, state), meta


def _whole_like(axes, leaf, mesh):
    """An empty host tensor of the whole leaf's shape, the template a
    restore fills."""
    shape = list(leaf.shape)
    for dim, ax in enumerate(sharding.dim_axes(*axes)):
        shape[dim] *= mesh.size(ax)
    return torch.empty(shape, dtype=leaf.dtype)


if __name__ == "__main__":
    main()
