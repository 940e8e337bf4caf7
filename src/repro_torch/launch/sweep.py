"""Sweep launcher: trace a Pareto front into a durable plan store
(``repro.launch.sweep``).

    # cnn track (the paper's reference networks) with adaptive bisection
    # and fixed-precision baselines for the iso-accuracy report:
    PYTHONPATH=src python -m repro_torch.launch.sweep --device cpu \
        --track cnn --bench gsc --width 4 --lams 2,20 --adaptive 1 \
        --warmup-steps 4 --search-steps 4 --finetune-steps 2 --baselines

    # lm track: plans the port's InferenceServer binds directly
    PYTHONPATH=src python -m repro_torch.launch.sweep --device cpu \
        --track lm --bench llama3.2-1b-smoke --lams 0.5,4 --search-steps 4

Runs on ``cuda`` unless ``--device`` names another device, and raises
when there is no card.  Kill/resume: re-running the same command against
the same ``--store``/``--workdir`` loads finished points from the store
and resumes the in-flight point from its checkpoint; ``--max-points N``
bounds how many points one invocation executes.  ``--metrics PATH`` /
``--trace PATH`` write the ``sweep_*`` / ``compress_*`` metrics and the
``point_*`` lifecycle trace (the JAX package's names; check them with
``python -m repro_torch.obs.validate``).
"""
from __future__ import annotations

import argparse
import json

from repro_torch import obs as obs_mod
from repro_torch import sweep as sweep_mod


def build_spec(args) -> sweep_mod.SweepSpec:
    kw = dict(
        name=args.name, track=args.track, bench=args.bench,
        cost_model=args.cost_model,
        lams=tuple(float(x) for x in args.lams.split(",") if x),
        adaptive_points=args.adaptive,
        warm_start=not args.cold,
        warmup_steps=args.warmup_steps, search_steps=args.search_steps,
        warm_search_steps=args.warm_search_steps,
        finetune_steps=args.finetune_steps, batch=args.batch,
        seed=args.seed, width=args.width, seq=args.seq,
        eval_batches=args.eval_batches,
        checkpoint_every=args.checkpoint_every)
    if args.lm_lr is not None:
        kw["lm_lr"] = args.lm_lr
    return sweep_mod.SweepSpec(**kw)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", default="sweep")
    ap.add_argument("--track", default="lm", choices=["cnn", "lm"])
    ap.add_argument("--bench", default="llama3.2-1b-smoke",
                    help="cnn: bench name (gsc/cifar10); lm: arch name")
    ap.add_argument("--cost-model", default="size")
    ap.add_argument("--lams", default="0.5,4",
                    help="comma-separated regularization strengths")
    ap.add_argument("--adaptive", type=int, default=0,
                    help="extra bisection points inserted into the "
                         "largest front gaps after the grid")
    ap.add_argument("--cold", action="store_true",
                    help="disable warm-start continuation")
    ap.add_argument("--warmup-steps", type=int, default=60)
    ap.add_argument("--search-steps", type=int, default=60)
    ap.add_argument("--warm-search-steps", type=int, default=None)
    ap.add_argument("--finetune-steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--lm-lr", type=float, default=None)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--store", default="sweep_store")
    ap.add_argument("--workdir", default="sweep_work")
    ap.add_argument("--max-points", type=int, default=None,
                    help="execute at most N points this invocation "
                         "(store hits are free); rerun to continue")
    ap.add_argument("--baselines", action="store_true",
                    help="also train fixed w8/w2 references and print "
                         "the iso-accuracy report (cnn track)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write sweep metrics in Prometheus text format")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the point lifecycle trace as JSON lines")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write the sweep summary as JSON")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    spec = build_spec(args)
    store = sweep_mod.PlanStore(args.store)
    obs = obs_mod.Observability() if (args.metrics or args.trace) \
        else None
    runner = sweep_mod.SweepRunner(
        spec, store, args.workdir,
        registry=obs.registry if obs else None,
        tracer=obs.tracer if obs else None, device=args.device)
    summary = runner.run(max_points=args.max_points)

    print(f"[sweep] {summary['executed']} executed, "
          f"{summary['loaded']} loaded from store, "
          f"{summary['steps_executed']} steps run, "
          f"{summary['steps_saved']} steps saved by warm starts")
    front = store.front(store.query(kind="point", sweep=spec.name),
                        cost_key=spec.cost_model)
    for e in front:
        lin = e["lineage"]
        print(f"[sweep] front: {e['name']} lam={lin['lam']:g} "
              f"score={e['metrics']['score']:.4f} "
              f"cost={e['costs'][spec.cost_model]:.1f} "
              f"plan={e['plan'][:12]}")

    if args.baselines:
        for bits in (8, 2):
            runner.baseline(bits)
        iso = runner.iso_report()
        for label, row in iso.items():
            print(f"[sweep] iso-accuracy vs {label}: "
                  f"reduction={row['reduction_pct']}% "
                  f"(baseline score={row['baseline_score']:.4f})")
        summary["iso_report"] = iso

    if obs is not None and args.metrics:
        obs_mod.write_prometheus(obs.registry, args.metrics)
        print(f"[sweep] wrote {args.metrics}")
    if obs is not None and args.trace:
        obs_mod.write_trace(obs.tracer, args.trace)
        print(f"[sweep] wrote {args.trace}")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"[sweep] wrote {args.report}")
    return summary


if __name__ == "__main__":
    main()
