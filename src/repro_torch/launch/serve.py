"""Serving launcher: plan-driven continuous-batching decode on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --plan demo --cache paged --requests 8 --tokens 32

    # on the CPU, at the smoke size:
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch llama3.2-1b-smoke --plan demo --cache paged --page-size 8

    # pure SSM (Mamba-2): exact-length prefill, K5 on CUDA, no KV pages
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mamba2-780m-smoke --plan demo --cache paged --prompt-len 33

    # MoE (llama4-scout: chunked attention, 16 experts top-1 + a shared
    # FFN; arctic: 128 experts top-2 + a shared FFN): the router and the
    # expert banks stay float under a plan, the attention and shared-FFN
    # projections are its groups
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch llama4-scout-17b-a16e-smoke --plan demo --cache paged

Weights are random (``lm.init_params``, seeded); ``--plan`` takes a saved
CompressionPlan stem (either package's) or ``demo`` for a synthetic
mixed-precision plan.  Temperature / top-k sampling runs on the device
(threefry2x32 Gumbel noise, the JAX package's stream); ``--host-sampling``
samples with the host's numpy generator instead.  ``--profile`` serves
the same requests once more under ``torch.profiler`` and prints the
device time by kernel and the device's busy share of that run (CUDA
only).  ``--metrics PATH`` / ``--trace PATH`` attach the observability
layer and write the Prometheus metrics and the per-request lifecycle
trace (JSON lines) that ``python -m repro_torch.obs.validate`` checks --
the JAX package's names, labels and event grammar.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.obs import Observability, write_prometheus, write_trace
from repro_torch.serve import engine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Request


def _load_plan(spec: str, cfg, params):
    if spec == "demo":
        return engine.synthetic_plan(cfg, params, bits=None, seed=0)
    from repro_torch.api.plan import CompressionPlan
    return CompressionPlan.load(spec)


# the port's hand-written kernels, as the profiler names them
_PORT_KERNELS = ("qmm_kernel", "qmv_kernel", "paged_decode_mma_kernel",
                 "paged_decode_split_kernel", "paged_decode_merge_kernel",
                 "paged_prefill_mma_kernel", "paged_prefill_kernel",
                 "ssd_scan_kernel")


def _profile(server, reqs):
    """Serve ``reqs`` again under the profiler; print the kernels by
    device time, each of the port's kernels' device time per admission
    and per decode step, and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device time: the kernel rows only (an operator's row repeats the
    # time of the kernels it launched)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25))
    st = server.stats
    for name in _PORT_KERNELS:
        hit = [e for e in events
               if f"::{name}<" in e.key or f"::{name}(" in e.key]
        if hit:
            us = sum(e.self_device_time_total for e in hit)
            print(f"[profile] {name}: {us / 1e3:.3f} ms device in "
                  f"{sum(e.count for e in hit)} launches = "
                  f"{us / 1e3 / max(st['admitted'], 1):.3f} ms an "
                  f"admission (of {st['admitted']}) or "
                  f"{us / 1e3 / max(st['decode_steps'], 1):.3f} ms a "
                  f"decode step (of {st['decode_steps']})")
    print(f"[profile] {st['decode_steps']} decode steps and "
          f"{st['admitted']} admissions in {wall:.3f} s; "
          f"{sum(e.count for e in events)} kernel launches; device busy "
          f"{dev_us / 1e6:.3f} s = {100 * dev_us / 1e6 / wall:.1f}% of the "
          f"window (kernel time summed; the profiler slows the host)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b-smoke")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="decode slots (requests beyond this queue)")
    ap.add_argument("--plan", default=None,
                    help="CompressionPlan stem/path for quantized decode, "
                         "or 'demo' for a synthetic mixed-precision plan")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream", action="store_true",
                    help="streaming-arrivals mode: requests join the "
                         "queue over time instead of all at step 0")
    ap.add_argument("--arrival-gap", type=int, default=2,
                    help="decode steps between arrivals with --stream")
    ap.add_argument("--cache", default="dense", choices=["dense", "paged"])
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per page (must divide --max-len)")
    ap.add_argument("--pages", type=int, default=None,
                    help="page-pool size (default: dense-equivalent)")
    ap.add_argument("--host-sampling", action="store_true",
                    help="sample on the host per token (numpy "
                         "generator) instead of on the device")
    ap.add_argument("--profile", action="store_true",
                    help="serve the requests once more under "
                         "torch.profiler (CUDA)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="enable observability and write the metrics "
                         "registry in Prometheus text format to PATH")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable observability and write the per-request "
                         "lifecycle trace as JSON lines to PATH")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.profile and device.type != "cuda":
        raise SystemExit("--profile traces the CUDA device; it needs "
                         "--device cuda")
    cfg = registry.get(args.arch)
    params = lm.init_params(cfg, device=device)
    plan = None
    if args.plan is not None:
        plan = _load_plan(args.plan, cfg, params)
        print(f"[serve] quantized decode: {plan.summary()}")
    obs = Observability() if (args.metrics or args.trace) else None
    server = engine.InferenceServer(
        cfg, params, plan=plan, max_len=args.max_len,
        max_batch=args.max_batch, cache=args.cache,
        page_size=args.page_size, pages=args.pages,
        sample_on_device=not args.host_sampling, obs=obs, device=device)

    rng = np.random.default_rng(0)
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        max_tokens=args.tokens, seed=args.seed)
    reqs = [Request(uid=i, prompt=rng.integers(
                0, cfg.vocab, size=args.prompt_len).astype(np.int32),
                    sampling=sp,
                    arrival=i * args.arrival_gap if args.stream else 0)
            for i in range(args.requests)]

    t0 = time.perf_counter()
    out = server.serve(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in out.values())
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[serve] {args.requests} requests x {args.tokens} tokens "
          f"({'stream' if args.stream else 'batch'}, "
          f"{'quantized' if plan is not None else 'float'}, {args.cache} "
          f"cache) on {where} in {dt:.2f}s ({total / dt:.1f} tok/s, "
          f"{server.stats['decode_steps']} decode steps, "
          f"{server.stats['preemptions']} preemptions)")
    mem = server.stats["memory"]
    if mem["backend"] == "paged":
        print(f"[serve] memory: peak {mem['peak_cache_bytes']} B "
              f"({mem['peak_pages_in_use']}/{mem['n_pages']} pages of "
              f"{mem['bytes_per_page']} B, {mem['ssm_slot_bytes']} B of "
              f"SSM state a slot) vs dense-equivalent "
              f"{mem['dense_equivalent_bytes']} B")
    else:
        print(f"[serve] memory: dense cache {mem['cache_bytes']} B")
    for i in range(min(args.requests, 4)):
        print(f"  req{i}: prompt={[int(t) for t in reqs[i].prompt[:6]]}... "
              f"completion={[int(t) for t in out[i][:8]]}")
    if obs is not None:
        _write_obs(server, obs, args)
    if args.profile:
        _profile(server, reqs)


def _write_obs(server, obs, args):
    """Print the traced run's latency summary (host wall clock) and
    write the requested artifacts."""
    summary = server.metrics_snapshot().get("summary", {})
    if summary:
        ttft = summary["ttft_s"]
        tok = summary["token_latency_s"]
        fmt = lambda v: "n/a" if v is None else f"{v * 1e3:.1f}ms"
        print(f"[obs] ttft p50={fmt(ttft['p50'])} "
              f"p95={fmt(ttft['p95'])} p99={fmt(ttft['p99'])} | "
              f"token p50={fmt(tok['p50'])} p95={fmt(tok['p95'])} "
              f"p99={fmt(tok['p99'])} | "
              f"preemptions={summary['preemptions']} "
              f"pages_hwm={summary['pages_held_hwm']}")
        widths = summary.get("decode_width_steps")
        if widths:
            print(f"[obs] decode steps per live-table width: {widths}")
    if args.metrics:
        write_prometheus(obs.registry, args.metrics)
        print(f"[obs] metrics -> {args.metrics}")
    if args.trace:
        write_trace(obs.tracer, args.trace)
        print(f"[obs] trace -> {args.trace} "
              f"({len(obs.tracer.events)} events)")


if __name__ == "__main__":
    main()
