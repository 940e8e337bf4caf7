"""Search launcher: the paper's Warmup -> JointSearch -> Finetune on the
port, one reference CNN on its synthetic dataset.

    PYTHONPATH=src python -m repro_torch.launch.search --arch resnet18 \
        --data tinyimagenet --batch 32 --steps 4,6,4

    # on the CPU, at a small size:
    PYTHONPATH=src python -m repro_torch.launch.search --device cpu \
        --arch dscnn --width 8 --data gsc --batch 8 --steps 3,3,2

``--profile N`` times N extra search steps untraced, then traces N more
with ``torch.profiler`` and prints the device time by kernel, the device
operations (kernels, copies) a step and the device's busy share of the
traced window (CUDA only).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.api import compressor, phases
from repro_torch.data import synthetic
from repro_torch.models import cnn


def _profile(comp, res, args, n_steps: int):
    """Time ``n_steps`` JointSearch steps continuing from the result's
    network and selection parameters, then trace as many; print the
    kernels by device time, the device operations a step and the
    device's busy share of the traced window."""
    from torch.profiler import ProfilerActivity, profile

    state = phases.CompressionState(
        graph=comp.graph, spec=comp.spec, pw=comp.pw, px=comp.px,
        batch=comp.batch, seed=comp.seed, device=comp.device,
        folded=res.folded, acc_float=res.acc_float)
    search = phases.JointSearch(steps=n_steps + 1, lam=args.lam)
    ts = search.init_train_state(state)
    search.run(state, start_step=n_steps, train_state=ts)   # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    search.run(state, start_step=1, train_state=ts)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search.run(state, start_step=1, train_state=ts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device time: the kernel rows only (an operator's row repeats the
    # time of the kernels it launched)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25))
    # the timed window runs n_steps steps plus the final discretize and
    # evaluation of JointSearch.run
    print(f"[profile] untraced: {n_steps} search steps + discretize in "
          f"{untraced:.3f} s = {1e3 * untraced / n_steps:.1f} ms a step")
    print(f"[profile] {n_steps} search steps + discretize in {wall:.3f} s; "
          f"{launches} device operations (kernels, copies) = "
          f"{launches / n_steps:.0f} a step; "
          f"device busy {dev_us / 1e6:.3f} s = "
          f"{100 * dev_us / 1e6 / wall:.1f}% of the window (kernel time "
          f"summed; overlapping streams would count twice; the profiler "
          f"slows the host)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="resnet18", choices=sorted(
        cnn.CNN_BUILDERS))
    ap.add_argument("--width", type=int, default=None,
                    help="base width (resnet9 / dscnn only)")
    ap.add_argument("--data", default="tinyimagenet",
                    choices=sorted(synthetic.DATASETS))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", default="4,6,4",
                    help="warmup,search,finetune steps")
    ap.add_argument("--lam", type=float, default=5.0)
    ap.add_argument("--cost-model", default="size")
    ap.add_argument("--pw", default="0,2,4,8")
    ap.add_argument("--px", default="8")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", type=int, default=0,
                    help="trace this many extra search steps (CUDA)")
    args = ap.parse_args(argv)

    spec = synthetic.DATASETS[args.data]
    kw = {"num_classes": spec.num_classes, "in_shape": spec.shape}
    if args.width is not None:
        kw["width"] = args.width
    graph = cnn.CNN_BUILDERS[args.arch](**kw)
    w, s, f = (int(v) for v in args.steps.split(","))
    comp = compressor.Compressor(
        graph, spec, pw=tuple(int(v) for v in args.pw.split(",")),
        px=tuple(int(v) for v in args.px.split(",")), batch=args.batch,
        seed=args.seed, device=args.device)
    t0 = time.perf_counter()
    res = comp.run([phases.Warmup(steps=w),
                    phases.JointSearch(steps=s, lam=args.lam,
                                       cost_model=args.cost_model),
                    phases.Finetune(steps=f)],
                   hooks=[phases.MetricsLog(every=1)])
    if comp.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(comp.device) \
        if comp.device.type == "cuda" else "cpu"
    print(f"[search] {args.arch} on {spec.name} {spec.shape}, batch "
          f"{args.batch}, steps {w}/{s}/{f} on {where} in {dt:.2f} s; "
          f"phase wall {res.timings}")
    print(f"[search] {res.plan.summary()}; acc float {res.acc_float:.4f}, "
          f"final {res.acc_final:.4f}; size {res.size_bytes:.0f} B, "
          f"pruned {100 * res.prune_fraction:.1f}%")
    if args.profile and comp.device.type == "cuda":
        _profile(comp, res, args, args.profile)


if __name__ == "__main__":
    main()
