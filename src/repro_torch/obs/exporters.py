"""Exporters: Prometheus text format, JSONL trace, end-of-run summary.

All three read from the registry/tracer objects in ``repro_torch.obs`` and
write plain text -- no external dependencies, so they run anywhere the
repo runs (including the CI smoke stage, which round-trips the output
through ``repro_torch.obs.validate``).
"""
from __future__ import annotations

import json

import numpy as np


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def to_prometheus(registry) -> str:
    """Render a registry in the Prometheus text exposition format."""
    lines = []
    for name, fam in registry.snapshot().items():
        if fam["help"]:
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['kind']}")
        for s in fam["series"]:
            if fam["kind"] == "histogram":
                for le, cum in s["buckets"]:
                    lbl = dict(s["labels"])
                    lbl["le"] = (le if le == "+Inf"
                                 else _fmt_value(le))
                    lines.append(f"{name}_bucket{_fmt_labels(lbl)} "
                                 f"{cum}")
                lines.append(f"{name}_sum{_fmt_labels(s['labels'])} "
                             f"{repr(float(s['sum']))}")
                lines.append(f"{name}_count{_fmt_labels(s['labels'])} "
                             f"{s['count']}")
            else:
                lines.append(f"{name}{_fmt_labels(s['labels'])} "
                             f"{_fmt_value(s['value'])}")
    return "\n".join(lines) + "\n" if lines else ""


def write_prometheus(registry, path: str):
    with open(path, "w") as f:
        f.write(to_prometheus(registry))


def trace_to_jsonl(tracer) -> str:
    """One JSON object per trace event, in recording order."""
    return "".join(json.dumps(ev.to_json(), sort_keys=True) + "\n"
                   for ev in tracer.events)


def write_trace(tracer, path: str):
    with open(path, "w") as f:
        f.write(trace_to_jsonl(tracer))


def percentiles(xs) -> dict:
    """p50/p95/p99 of a sequence (None values when empty)."""
    if xs is None or len(xs) == 0:
        return {"p50": None, "p95": None, "p99": None}
    a = np.asarray(list(xs), dtype=np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99))}


def run_summary(tracer, registry=None) -> dict:
    """End-of-run summary for one traced serve run.

    Latency percentiles come from the tracer (per-run); the decode-path
    breakdown and top-k skip rate come from the registry when given
    (cumulative across runs on the same server).
    """
    out = {
        "requests": len(tracer.uids()),
        "tokens": len(tracer.token_latencies()),
        "preemptions": tracer.preemption_count(),
        "pages_held_hwm": tracer.pages_held_hwm(),
        "ttft_s": percentiles(tracer.ttfts()),
        "token_latency_s": percentiles(tracer.token_latencies()),
        "queue_wait_s": percentiles(tracer.queue_waits()),
    }
    if registry is not None and registry.enabled:
        snap = registry.snapshot()
        steps = snap.get("serve_decode_steps_total")
        if steps is not None:
            width_steps: dict = {}
            widths: dict = {}
            for s in steps["series"]:
                w = s["labels"].get("width", "?")
                width_steps[w] = width_steps.get(w, 0) + int(s["value"])
                # one (path, width) series == one decode callable
                # compiled for that static width
                widths[w] = widths.get(w, 0) + 1
            out["decode_width_steps"] = width_steps
            out["decode_compiles_per_width"] = widths
        skip = snap.get("serve_topk_sort_steps_total")
        if skip is not None:
            by = {s["labels"].get("skipped"): s["value"]
                  for s in skip["series"]}
            total = sum(by.values())
            if total:
                out["topk_sort_skip_rate"] = float(
                    by.get("true", 0.0) / total)
    return out
