"""Multi-pod dry-run of the port (``repro.launch.dryrun``): trace every
(architecture x input-shape) cell's step on the production meshes and
extract the roofline terms, with no card and no JAX.

One process stands for rank 0 of a ``fake`` process group of 256 (16 x
16) or 512 (2 x 16 x 16) ranks
(``torch.testing._internal.distributed.fake_pg``): the collectives
return at once, every tensor is on the ``meta`` device (shapes and
dtypes, no data), and the step of ``steps.cell_artifacts`` runs once,
eagerly, under ``distributed.cost_analysis``' counters -- the
counterpart of lowering and compiling the cell::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape decode_32k [--multi-pod] [--search]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--skip-existing]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --reanalyze

``--mesh D,M`` traces on a ``(data, model)`` debug mesh over a fake
group of ``D * M`` ranks instead, and ``--batch`` / ``--seq`` cut the
shape (smoke archs on small meshes).

Artifacts: ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__search]
.json`` with the reference's record keys where they have a meaning
(``ok``, ``skipped``, ``error``, ``collectives``, ``roofline``,
``memory_analysis``), and beside it ``....tally.json``, the per-operator
tally and the collective ledger, from which ``--reanalyze`` recomputes
``collectives`` and ``roofline`` without tracing again (the counterpart
of re-analysing the stored HLO).  The roofline is a model from the
H100's datasheet peaks (``cost_analysis.Roofline``), not a measurement.

Cells that ``cell_applicable`` skips are skipped; every other cell of
every family traces (under ``--all`` the exit code is 1 when one
fails).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, cell_applicable
from repro_torch.distributed import cost_analysis, sharding
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps as steps_lib

OUT = "artifacts/dryrun_torch"


def fake_group(n: int):
    """This process as rank 0 of a ``fake`` process group of ``n``
    ranks (a group of another size is replaced)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def mesh_label(multi_pod: bool, mesh=None) -> str:
    if mesh is not None:
        return f"{mesh[0]}x{mesh[1]}"
    return "2x16x16" if multi_pod else "16x16"


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _memory(args, out, donate, tracker) -> dict:
    """Argument and output bytes exactly (this rank's ``meta`` tensors),
    the outputs that are donated arguments updated in place (alias), and
    torch's own tracker's peak of the step's allocations on the fake
    tensors (``MemTracker``), with the arguments beside it."""
    donated = {id(t) for i in donate for t in _tensors(args[i])}
    outs = list(_tensors(out))
    rec = {"argument_bytes": _bytes(_tensors(args)),
           "output_bytes": _bytes(outs),
           "alias_bytes": _bytes(t for t in outs if id(t) in donated)}
    try:
        peak = tracker.get_tracker_snapshot("peak")
        step_peak = max(v["Total"] for v in peak.values()) if peak else 0
        rec["step_peak_bytes"] = step_peak
        rec["peak_bytes_est"] = rec["argument_bytes"] + step_peak
        rec["peak_source"] = ("torch.distributed._tools.mem_tracker."
                              "MemTracker on meta tensors, the arguments "
                              "added")
    except Exception as e:  # a torch without the tracker's snapshot
        rec["peak_error"] = f"{type(e).__name__}: {e}"
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             search: bool = False, verbose: bool = True, mesh=None,
             batch=None, seq=None):
    """Trace one cell: ``(record, tally)`` (``tally`` None unless the
    cell ran).  ``mesh`` ``(D, M)`` takes a debug mesh in place of the
    production one; ``batch`` / ``seq`` replace the shape's."""
    cfg = registry.get(arch)
    shape = SHAPES[shape_name]
    if batch or seq:
        shape = dataclasses.replace(
            shape, global_batch=batch or shape.global_batch,
            seq_len=seq or shape.seq_len)
    ok, reason = cell_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": mesh_label(multi_pod, mesh), "search": search}
    if batch or seq:
        rec.update(global_batch=shape.global_batch, seq_len=shape.seq_len)
    if not ok:
        rec["skipped"] = reason
        return rec, None
    n = (mesh[0] * mesh[1]) if mesh is not None else \
        (512 if multi_pod else 256)
    tally = None
    t0 = time.time()
    try:
        fake_group(n)
        dev = meshlib.make_debug_mesh(*mesh, device="meta") \
            if mesh is not None else \
            meshlib.make_production_mesh(multi_pod=multi_pod)
        # a smoke variant takes its architecture's overrides
        rules = dict(registry.RULE_OVERRIDES.get(
            arch.removesuffix("-smoke"), {}))
        rules.update(steps_lib.shape_rules(shape))
        from torch.distributed._tools.mem_tracker import MemTracker
        tracker = MemTracker()
        with sharding.use_mesh(dev, rules):
            step, args, in_sh, out_sh, donate = steps_lib.cell_artifacts(
                cfg, shape, dev, search=search)
            t_build = time.time() - t0
            grad = contextlib.nullcontext() if shape.kind == "train" \
                else torch.no_grad()
            with grad, tracker:
                out, totals, tally = cost_analysis.trace(step, *args)
        t_trace = time.time() - t0 - t_build
        roof = cost_analysis.Roofline.of(totals, n)
        rec.update({
            "ok": True,
            "build_s": round(t_build, 2),
            "trace_s": round(t_trace, 2),
            "memory_analysis": _memory(args, out, donate, tracker),
            "collectives": {
                "bytes_by_kind": totals.coll_bytes,
                "count_by_kind": totals.coll_counts,
                "traffic_bytes": totals.collective_traffic_bytes,
            },
            "roofline": roof.as_dict(),
            "op_calls": sum(r["count"] for r in tally["ops"].values()),
            "donate": list(donate),
        })
        tally["n_devices"] = n
        if verbose:
            print(_line(rec), flush=True)
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        tally = None
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']} FAILED: "
                  f"{rec['error']}", flush=True)
    return rec, tally


def _line(rec) -> str:
    r = rec["roofline"]
    return (f"[dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']}"
            f"{' [search]' if rec['search'] else ''}: traced in "
            f"{rec['trace_s']:.1f}s | {r['flops_per_device']:.4g} FLOP, "
            f"{r['bytes_per_device']:.4g} B, "
            f"{rec['collectives']['traffic_bytes']:.4g} B of collective "
            f"traffic a rank | compute {r['compute_s']:.4f}s memory "
            f"{r['memory_s']:.4f}s collective {r['collective_s']:.4f}s -> "
            f"{r['dominant']}-bound (a model from the datasheet peaks of "
            f"{r['card']}: {cost_analysis.PEAK_FLOPS / 1e12:.0f} TFLOP/s "
            f"bf16, {cost_analysis.HBM_BW / 1e12:.2f} TB/s HBM3, "
            f"{cost_analysis.LINK_BW / 1e9:.0f} GB/s NVLink a direction)")


def artifact_path(out_dir, arch, shape_name, multi_pod, search, mesh=None):
    sfx = "__search" if search else ""
    return os.path.join(
        out_dir, f"{arch}__{shape_name}__{mesh_label(multi_pod, mesh)}"
        f"{sfx}.json")


def tally_path(path: str) -> str:
    return path[:-len(".json")] + ".tally.json"


def write(path, rec, tally):
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    if tally is not None:
        with open(tally_path(path), "w") as f:
            json.dump(tally, f)


def reanalyze(out_dir: str):
    """Recompute ``collectives`` and ``roofline`` of every record from
    its stored tally (no trace)."""
    for fname in sorted(os.listdir(out_dir)):
        if not fname.endswith(".json") or fname.endswith(".tally.json"):
            continue
        path = os.path.join(out_dir, fname)
        with open(path) as f:
            rec = json.load(f)
        if not rec.get("ok"):
            continue
        try:
            with open(tally_path(path)) as f:
                tally = json.load(f)
        except FileNotFoundError:
            print(f"[reanalyze] no tally for {fname}")
            continue
        totals = cost_analysis.Totals.from_tally(
            tally["ops"], tally["coll_counts"], tally["coll_bytes"])
        roof = cost_analysis.Roofline.of(totals, tally["n_devices"])
        rec["collectives"] = {
            "bytes_by_kind": totals.coll_bytes,
            "count_by_kind": totals.coll_counts,
            "traffic_bytes": totals.collective_traffic_bytes}
        rec["roofline"] = roof.as_dict()
        with open(path, "w") as f:
            json.dump(rec, f, indent=2, default=str)
        print(f"[reanalyze] {fname}: {roof.dominant}-bound")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--search", action="store_true",
                    help="trace the paper's joint MPS+pruning search step")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--reanalyze", action="store_true",
                    help="recompute analyses from stored tallies, no trace")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--mesh", default=None,
                    help="D,M: a (data, model) debug mesh over a fake group "
                         "of D*M ranks in place of the production mesh")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.reanalyze:
        reanalyze(args.out)
        return 0
    mesh = tuple(int(v) for v in args.mesh.split(",")) if args.mesh \
        else None

    cells = []
    if args.all:
        for arch in registry.ARCHS:
            for shape_name in SHAPES:
                cells.append((arch, shape_name, False, False))
                cells.append((arch, shape_name, True, False))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells.append((args.arch, args.shape, args.multi_pod, args.search))

    n_fail = 0
    try:
        for arch, shape_name, mp, search in cells:
            path = artifact_path(args.out, arch, shape_name, mp, search, mesh)
            if args.skip_existing and os.path.exists(path):
                continue
            rec, tally = run_cell(arch, shape_name, multi_pod=mp,
                                  search=search, mesh=mesh,
                                  batch=args.batch, seq=args.seq)
            write(path, rec, tally)
            if rec.get("ok") is False:
                n_fail += 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
