"""Fleet launcher: multi-replica serving across plan tiers with a
Pareto-aware router, deadline admission and an open-loop load trace
(``repro.launch.fleet``).

    # four tiers of full-width llama3.2-1b on one card, Pareto-degrade
    # routing, chaos with failover, obs artifacts:
    PYTHONPATH=src python -m repro_torch.launch.fleet \\
        --arch llama3.2-1b --tiers float,w8,mixed,w2 --max-len 1024 \\
        --max-batch 8 --page-size 16 --chaos crash+slow \\
        --metrics fleet.prom --trace fleet.jsonl --report fleet.json

    # on the CPU, at the smoke size:
    PYTHONPATH=src python -m repro_torch.launch.fleet --device cpu \\
        --arch llama3.2-1b-smoke --tiers float,w8,demo \\
        --chaos crash+slow+nan_plan+pool_pressure --chaos-seed 7

Tier specs (comma-separated), in plan-source order:

* ``store:<dir>`` -- every Pareto-front entry of a PlanStore (either
  package's sweep writes the same format) becomes one tier, named after
  its entry;
* ``store:<dir>/<name>`` -- one named store entry;
* a CompressionPlan stem/path (``plan`` / ``plan.npz`` / ``plan.json``);
* ``float`` (no plan), ``w<bits>`` (uniform synthetic plan), and
  ``demo`` / ``mixed`` (seeded random synthetic plan, the JAX package's
  draws).

Every replica serves the same seeded random weights (one parameter
tree, on ``--device``: ``cuda`` unless named, raising without a card).
Token content is real -- each replica runs K1 (plan-bound projections),
K2 (paged decode) and K3 (paged prefill) on the card -- while every
latency the fleet reports (TTFT, token latency, deadlines, attainment)
is on its modelled virtual clock (``repro_torch.fleet.fleet``), not the
card's.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch import fleet as fleet_mod
from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve import engine


def _store_tiers(ref: str, base_step_ms: float):
    """``store:`` tier source: ``ref`` is a PlanStore root (-> one tier
    per Pareto-front entry) or ``<root>/<entry-name>`` (-> one tier)."""
    from repro_torch.sweep import PlanStore, StoreError

    def is_store(path: str) -> bool:
        return os.path.isdir(os.path.join(path, "entries"))

    if is_store(ref):
        store, name = PlanStore(ref), None
    elif "/" in ref and is_store(ref.rsplit("/", 1)[0]):
        root, name = ref.rsplit("/", 1)
        store = PlanStore(root)
    else:
        raise StoreError(f"store:{ref}: {ref!r} is not a PlanStore root "
                         f"(no entries/ directory) or <root>/<name>")
    entries = [store.entry(name)] if name is not None else \
        store.front(store.query(kind="point") or None)
    if not entries:
        raise StoreError(f"store:{ref}: the store has no entries")
    return [fleet_mod.tier_from_plan(e["name"], store.get(e["plan"]),
                                     base_step_ms=base_step_ms)
            for e in entries]


def build_tiers(spec: str, cfg, params, base_step_ms: float):
    """Tier spec -> list of TierSpec (``store:<dir>`` may expand to
    several; every other form yields exactly one)."""
    if spec.startswith("store:"):
        return _store_tiers(spec[len("store:"):], base_step_ms)
    if spec == "float":
        plan = None
    elif spec in ("demo", "mixed"):
        plan = engine.synthetic_plan(cfg, params, bits=None, seed=0)
    elif spec.startswith("w") and spec[1:].isdigit():
        plan = engine.synthetic_plan(cfg, params, bits=int(spec[1:]))
    else:
        from repro_torch.api.plan import CompressionPlan
        plan = CompressionPlan.load(spec)
    return [fleet_mod.tier_from_plan(spec, plan,
                                     base_step_ms=base_step_ms)]


def build_tier(spec: str, cfg, params, base_step_ms: float):
    """Tier spec -> one TierSpec (rejects ``store:<dir>`` specs that
    expand to several tiers)."""
    tiers = build_tiers(spec, cfg, params, base_step_ms)
    if len(tiers) != 1:
        raise ValueError(f"tier spec {spec!r} expands to {len(tiers)} "
                         f"tiers; use build_tiers()")
    return tiers[0]


def build_fleet(cfg, params, tier_specs, *, policy: str,
                max_len: int, max_batch: int, cache: str,
                page_size: int, pages, base_step_ms: float,
                metrics: bool = True, chaos=None,
                failover: bool = True, device=None) -> fleet_mod.Fleet:
    """One :class:`InferenceServer` per tier, every one built from the
    same ``params`` tree on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    pairs = []
    for spec in tier_specs:
        for tier in build_tiers(spec, cfg, params, base_step_ms):
            server = engine.InferenceServer(
                cfg, params, plan=tier.plan, max_len=max_len,
                max_batch=max_batch, cache=cache, page_size=page_size,
                pages=pages, device=device)
            pairs.append((tier, server))
    return fleet_mod.Fleet(pairs, policy=policy, metrics=metrics,
                           chaos=chaos, failover=failover)


def make_trace(args, vocab: int) -> list:
    """The open-loop arrival trace the flags describe."""
    deadline = args.deadline_ms if args.deadline_ms > 0 else None
    common = dict(vocab=vocab, prompt_len=args.prompt_len,
                  max_tokens=args.tokens, deadline_ms=deadline,
                  retry_budget=args.retry_budget,
                  temperature=args.temperature, top_k=args.top_k,
                  seed=args.seed)
    if args.trace_kind == "poisson":
        return fleet_mod.poisson_trace(args.requests,
                                       rate_rps=args.rate, **common)
    n_bursts = -(-args.requests // args.burst_size)
    return fleet_mod.burst_trace(
        n_bursts, args.burst_size,
        burst_every_ms=args.burst_every_ms, **common)[:args.requests]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b-smoke")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiers", default="float,demo",
                    help="comma-separated tier specs: store:<dir> (whole "
                         "front) or store:<dir>/<name>, a CompressionPlan "
                         "stem/path, float, w<bits>, demo/mixed")
    ap.add_argument("--policy", default="pareto_degrade",
                    help="round_robin | least_loaded | pareto_degrade | "
                         "static:<tier>")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=40.0,
                    help="open-loop Poisson arrival rate, requests per "
                         "virtual second")
    ap.add_argument("--trace-kind", default="poisson",
                    choices=["poisson", "burst"])
    ap.add_argument("--burst-size", type=int, default=4)
    ap.add_argument("--burst-every-ms", type=float, default=150.0)
    ap.add_argument("--deadline-ms", type=float, default=400.0,
                    help="per-request deadline on the virtual clock "
                         "(<=0 disables deadlines)")
    ap.add_argument("--retry-budget", type=int, default=1)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache", default="paged",
                    choices=["dense", "paged"])
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pages", type=int, default=None)
    ap.add_argument("--base-step-ms", type=float, default=8.0,
                    help="modelled decode-step cost of the float tier")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="deterministic fault schedule, e.g. "
                         "'crash+slow' or 'crash@40:w8+slow@30-200:x6' "
                         "(see repro_torch.chaos.parse_chaos); targets "
                         "default to seeded draws over the fleet's "
                         "tiers")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for the unpinned fields of --chaos")
    ap.add_argument("--no-failover", action="store_true",
                    help="disable crash recovery (struck replicas' "
                         "requests die with the fault terminal) -- the "
                         "ablation arm")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write the shared registry in Prometheus text "
                         "format to PATH")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the merged per-replica lifecycle trace "
                         "as JSON lines to PATH")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write the SLO report as JSON to PATH")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = registry.get(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    params = lm.init_params(cfg, gen, device=device)
    tier_specs = [s for s in args.tiers.split(",") if s]
    flt = build_fleet(cfg, params, tier_specs, policy=args.policy,
                      max_len=args.max_len, max_batch=args.max_batch,
                      cache=args.cache, page_size=args.page_size,
                      pages=args.pages, base_step_ms=args.base_step_ms,
                      failover=not args.no_failover, device=device)
    for rep in flt.replicas:
        print(f"[fleet] replica {rep.tier.name}: "
              f"quality={rep.tier.quality:.2f} bits, "
              f"modelled step={rep.tier.step_ms:.2f} ms")

    trace = make_trace(args, cfg.vocab)
    if args.chaos:
        from repro_torch.chaos import ChaosInjector, parse_chaos
        horizon = (trace[-1].arrival_ms if trace else 0.0) + 1000.0
        sched = parse_chaos(args.chaos,
                            targets=[r.tier.name for r in flt.replicas],
                            seed=args.chaos_seed, horizon_ms=horizon)
        for spec in sched:
            print(f"[chaos] {spec.describe()}")
        flt.chaos = ChaosInjector(sched)

    records = flt.run(trace)
    report = fleet_mod.slo_report(flt, records)
    st = report["status"]
    att = report["deadline_attainment"]
    print(f"[fleet] {len(records)} requests via {args.policy}: "
          f"{st['finished']} finished, {st['timeout']} timeout, "
          f"{st['shed']} shed, {report['degraded']} degraded, "
          f"{report['retries']} retries"
          + (f", attainment={att:.2%} (modelled clock)"
             if att is not None else ""))
    fmt = lambda v: "n/a" if v is None else f"{v:.1f}ms"
    for name, t in report["per_tier"].items():
        print(f"[fleet]   {name}: {t['requests']} served, modelled ttft "
              f"p50={fmt(t['ttft_ms']['p50'])} "
              f"p99={fmt(t['ttft_ms']['p99'])}, modelled token "
              f"p50={fmt(t['token_latency_ms']['p50'])}")
    if args.chaos:
        n_rec = sum(1 for r in records.values()
                    for a in r.attempts
                    if a.cause.startswith("recovered:"))
        print(f"[chaos] {len(flt.chaos.delivered)} fault events "
              f"delivered, {n_rec} requests recovered; "
              f"health: {flt.health.states()}")

    if args.metrics:
        from repro_torch.obs import write_prometheus
        write_prometheus(flt.registry, args.metrics)
        print(f"[obs] metrics -> {args.metrics}")
    if args.trace:
        flt.write_trace(args.trace)
        print(f"[obs] trace -> {args.trace} "
              f"({len(flt.trace_events())} events)")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"[fleet] report -> {args.report}")
    return report


if __name__ == "__main__":
    main()
