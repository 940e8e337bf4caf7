"""Validation tooling for exported observability artifacts
(``repro.obs.validate``).

Dependency-free on purpose:

    python -m repro_torch.obs.validate --metrics serve_metrics.prom \\
        --trace serve_trace.jsonl --schema tests/obs_schema.json

proves that (a) the Prometheus text output parses and is internally
consistent (TYPE lines precede samples, histogram buckets are
cumulative and end at ``+Inf == _count``), (b) every JSONL trace event
matches the checked-in schema, and (c) every request's event sequence
is a complete lifecycle per :meth:`RequestTracer.check_lifecycle`.

The schema checker implements the subset of JSON Schema the trace
schema uses (type / enum / required / properties / additionalProperties
/ minimum / items) rather than pulling in a jsonschema dependency.

:data:`SCHEMA_PATH` is the port's copy of that schema (the same JSON),
for callers that carry no copy of the repository's tests.  Either
package's validator accepts either package's artifacts.
"""
from __future__ import annotations

import argparse
import json
import os
import re

from .tracing import RequestTracer

# the trace-event schema, equal to the repository's tests/obs_schema.json
SCHEMA_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "trace_schema.json")

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(
    r'\s*(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"\s*(?:,|$)')


def parse_prometheus(text: str) -> dict:
    """Parse Prometheus text exposition into
    ``{family: {"type": str, "samples": [(name, labels, value)]}}``.

    Raises ValueError on malformed lines, samples without a preceding
    TYPE, or inconsistent histograms.
    """
    families: dict = {}
    types: dict = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "untyped"):
                raise ValueError(f"line {lineno}: malformed TYPE line")
            types[parts[2]] = parts[3]
            families.setdefault(parts[2],
                                {"type": parts[3], "samples": []})
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        name = m.group("name")
        fam = name
        for suffix in ("_bucket", "_sum", "_count"):
            if (name.endswith(suffix)
                    and types.get(name[:-len(suffix)]) == "histogram"):
                fam = name[:-len(suffix)]
                break
        if fam not in types:
            raise ValueError(f"line {lineno}: sample {name!r} has no "
                             f"preceding TYPE line")
        labels = {}
        raw = m.group("labels")
        if raw:
            pos = 0
            while pos < len(raw):
                lm = _LABEL_RE.match(raw, pos)
                if lm is None:
                    raise ValueError(f"line {lineno}: malformed labels "
                                     f"{raw!r}")
                labels[lm.group("k")] = (
                    lm.group("v").replace('\\"', '"')
                    .replace("\\n", "\n").replace("\\\\", "\\"))
                pos = lm.end()
        vs = m.group("value")
        value = float("inf") if vs == "+Inf" else float(vs)
        families[fam]["samples"].append((name, labels, value))
    _check_histograms(families)
    return families


def _check_histograms(families: dict):
    for fam, rec in families.items():
        if rec["type"] != "histogram":
            continue
        series: dict = {}
        for name, labels, value in rec["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            s = series.setdefault(key, {"buckets": [], "sum": None,
                                        "count": None})
            if name == fam + "_bucket":
                le = labels.get("le")
                if le is None:
                    raise ValueError(f"{fam}: bucket sample missing 'le'")
                s["buckets"].append(
                    (float("inf") if le == "+Inf" else float(le), value))
            elif name == fam + "_sum":
                s["sum"] = value
            elif name == fam + "_count":
                s["count"] = value
        for key, s in series.items():
            if not s["buckets"] or s["count"] is None or s["sum"] is None:
                raise ValueError(f"{fam}{dict(key)}: incomplete "
                                 f"histogram series")
            les = [le for le, _ in s["buckets"]]
            cums = [c for _, c in s["buckets"]]
            if les != sorted(les) or les[-1] != float("inf"):
                raise ValueError(f"{fam}{dict(key)}: buckets not "
                                 f"ascending to +Inf")
            if any(c2 < c1 for c1, c2 in zip(cums, cums[1:])):
                raise ValueError(f"{fam}{dict(key)}: bucket counts "
                                 f"not cumulative")
            if cums[-1] != s["count"]:
                raise ValueError(f"{fam}{dict(key)}: +Inf bucket "
                                 f"{cums[-1]} != count {s['count']}")
    return families


# ------------------------------------------------------------ JSON schema
def check_schema(obj, schema, path: str = "$") -> list:
    """Validate ``obj`` against the JSON-Schema subset used by
    ``tests/obs_schema.json``; returns a list of error strings."""
    errors: list = []
    t = schema.get("type")
    if t is not None:
        ok = {
            "object": lambda o: isinstance(o, dict),
            "array": lambda o: isinstance(o, list),
            "string": lambda o: isinstance(o, str),
            "integer": lambda o: isinstance(o, int)
            and not isinstance(o, bool),
            "number": lambda o: isinstance(o, (int, float))
            and not isinstance(o, bool),
            "boolean": lambda o: isinstance(o, bool),
            "null": lambda o: o is None,
        }[t](obj)
        if not ok:
            return [f"{path}: expected {t}, got "
                    f"{type(obj).__name__}"]
    if "enum" in schema and obj not in schema["enum"]:
        errors.append(f"{path}: {obj!r} not in enum {schema['enum']}")
    if "minimum" in schema and isinstance(obj, (int, float)) \
            and not isinstance(obj, bool) and obj < schema["minimum"]:
        errors.append(f"{path}: {obj} < minimum {schema['minimum']}")
    if isinstance(obj, dict):
        for req in schema.get("required", ()):
            if req not in obj:
                errors.append(f"{path}: missing required key {req!r}")
        props = schema.get("properties", {})
        for k, v in obj.items():
            if k in props:
                errors.extend(check_schema(v, props[k], f"{path}.{k}"))
            elif schema.get("additionalProperties", True) is False:
                errors.append(f"{path}: unexpected key {k!r}")
    if isinstance(obj, list) and "items" in schema:
        for i, v in enumerate(obj):
            errors.extend(check_schema(v, schema["items"],
                                       f"{path}[{i}]"))
    return errors


def validate_trace_lines(lines, schema) -> list:
    """Schema-check each JSONL event and lifecycle-check each request;
    returns a list of error strings (empty == valid)."""
    errors: list = []
    lifecycles: dict = {}
    order: list = []
    last_t = None
    for lineno, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError as e:
            errors.append(f"line {lineno}: not JSON ({e})")
            continue
        errs = check_schema(ev, schema, path=f"line {lineno}")
        errors.extend(errs)
        if errs:
            continue
        if last_t is not None and ev["t"] < last_t:
            errors.append(f"line {lineno}: timestamp {ev['t']} goes "
                          f"backwards (prev {last_t})")
        last_t = ev["t"]
        uid = ev["uid"]
        if uid not in lifecycles:
            order.append(uid)
        lifecycles.setdefault(uid, []).append(ev["kind"])
    for uid in order:
        err = RequestTracer.check_lifecycle(lifecycles[uid])
        if err is not None:
            errors.append(f"uid {uid}: invalid lifecycle "
                          f"{lifecycles[uid]}: {err}")
    return errors


def validate_files(metrics_path=None, trace_path=None,
                   schema_path=None) -> list:
    """Validate exported artifact files; returns error strings."""
    errors: list = []
    if metrics_path:
        with open(metrics_path) as f:
            text = f.read()
        try:
            fams = parse_prometheus(text)
            if not fams:
                errors.append(f"{metrics_path}: no metric families")
        except ValueError as e:
            errors.append(f"{metrics_path}: {e}")
    if trace_path:
        if not schema_path:
            errors.append("--trace requires --schema")
        else:
            with open(schema_path) as f:
                schema = json.load(f)
            with open(trace_path) as f:
                lines = f.readlines()
            if not any(line.strip() for line in lines):
                errors.append(f"{trace_path}: no trace events")
            errors.extend(f"{trace_path}: {e}"
                          for e in validate_trace_lines(lines, schema))
    return errors


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.validate",
        description="Validate exported metrics/trace artifacts")
    p.add_argument("--metrics", help="Prometheus text file")
    p.add_argument("--trace", help="JSONL trace file")
    p.add_argument("--schema", help="JSON schema for trace events")
    args = p.parse_args(argv)
    if not args.metrics and not args.trace:
        p.error("nothing to validate: pass --metrics and/or --trace")
    errors = validate_files(args.metrics, args.trace, args.schema)
    for e in errors:
        print(f"INVALID: {e}")
    if not errors:
        targets = [x for x in (args.metrics, args.trace) if x]
        print(f"OK: {', '.join(targets)} valid")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
