"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs`` on the CPU.

* The registry: the same seeded sequence of counter / gauge / histogram
  / phase-point calls gives byte-identical Prometheus text and equal
  snapshots.
* The tracer: the same lifecycle calls, each package's tracer reading a
  counting clock, give byte-identical trace JSON lines, Prometheus text
  and run summaries; the lifecycle grammar gives the same verdicts.
* ``validate``: both validators give the same verdicts (the same error
  lists) on the same good and broken files.
* The server: the port's ``InferenceServer(obs=Observability())`` and the
  JAX package's, serving the same requests from carried-across weights
  on a paged cache small enough to preempt, emit the same per-request
  event sequences (wall-clock ``t`` left out) and the same counter and
  gauge values and histogram counts.  Latency sums and buckets are wall
  clock and are not compared.
"""
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro import obs as jobs
from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.obs import tracing as jtracing
from repro.obs import validate as jvalidate
from repro.serve import engine as jeng
from repro.serve.sampling import SamplingParams as JSP
from repro.serve.scheduler import Request as JReq
from repro_torch import obs as tobs
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import registry as treg
from repro_torch.obs import tracing as ttracing
from repro_torch.obs import validate as tvalidate
from repro_torch.serve import engine as teng
from repro_torch.serve.sampling import SamplingParams as TSP
from repro_torch.serve.scheduler import Request as TReq

from torch_parity import (counting_clocks, events_without_t, jax_k1_plain,
                          obs_values)
from torch_threads import _one_torch_thread  # noqa: F401

SCHEMA = "tests/obs_schema.json"


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _registry_calls(seed: int) -> list:
    """A seeded list of (method, args, kwargs) registry calls."""
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(60):
        what = rng.integers(0, 5)
        lab = str(rng.choice(["a", "b", "c d", 'q"x']))
        if what == 0:
            calls.append(("counter", ("ops_total", "ops", ("kind",)),
                          ("inc", (float(rng.integers(0, 4)),),
                           {"kind": lab})))
        elif what == 1:
            calls.append(("gauge", ("level", "a level", ()),
                          ("set", (float(rng.normal()),), {})))
        elif what == 2:
            calls.append(("histogram", ("lat_seconds", "latency",
                                        ("replica",)),
                          ("observe", (float(rng.exponential(0.01)),),
                           {"replica": lab})))
        elif what == 3:
            calls.append(("histogram_b", ("size", "sizes", ()),
                          ("observe", (float(rng.integers(0, 40)),), {})))
        else:
            calls.append(("phase", (str(rng.choice(["search", "warmup"])),
                                    int(rng.integers(0, 20)),
                                    {"loss": float(rng.normal()),
                                     "acc": float(rng.random())}), None))
    return calls


def _replay(mod, calls, enabled=True):
    reg = mod.MetricsRegistry(enabled=enabled)
    for kind, args, op in calls:
        if kind == "phase":
            reg.emit_phase_point(*args)
            continue
        if kind == "histogram_b":
            metric = reg.histogram(*args, buckets=(1.0, 4.0, 16.0))
        else:
            metric = getattr(reg, kind)(*args)
        getattr(metric, op[0])(*op[1], **op[2])
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_calls_give_identical_prometheus(seed):
    calls = _registry_calls(seed)
    jreg_, treg_ = _replay(jobs, calls), _replay(tobs, calls)
    assert tobs.to_prometheus(treg_) == jobs.to_prometheus(jreg_)
    assert treg_.snapshot() == jreg_.snapshot()
    # a disabled registry hands out the no-op metric in both
    off = _replay(tobs, calls, enabled=False)
    assert off.snapshot() == {} == _replay(jobs, calls,
                                           enabled=False).snapshot()
    assert tobs.LATENCY_BUCKETS_S == jobs.LATENCY_BUCKETS_S


def test_registry_errors_match():
    for mod in (jobs, tobs):
        reg = mod.MetricsRegistry()
        reg.counter("x_total", labels=("a",))
        with pytest.raises(ValueError, match="registered with labels"):
            reg.counter("x_total", labels=("b",))
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x_total", labels=("a",))
        with pytest.raises(ValueError, match="cannot decrease"):
            reg.counter("x_total", labels=("a",)).inc(-1, a="1")


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

# (uid, kind, fields) -- a preemption and re-admission, a timeout that is
# re-enqueued, a crash with its recovery marker, a quarantine, and a sweep
# point's lifecycle
_LIFECYCLE = [
    (0, "enqueued", {}), (1, "enqueued", {"probe": True}),
    (0, "admitted", dict(n=6, pages_held=1, slot=0, resumed=False)),
    (0, "prefilled", dict(n=6, pages_held=1, slot=0)),
    (0, "first_token", dict(n=1, pages_held=1, slot=0)),
    (1, "admitted", dict(n=9, pages_held=2, slot=1, resumed=False)),
    (1, "prefilled", dict(n=9, pages_held=2, slot=1)),
    (1, "first_token", dict(n=1, pages_held=2, slot=1)),
    (0, "decode", dict(n=2, pages_held=1, slot=0)),
    (1, "preempted", dict(n=1, pages_held=0)),
    (0, "decode", dict(n=3, pages_held=2, slot=0)),
    (1, "admitted", dict(n=10, pages_held=2, slot=1, resumed=True)),
    (1, "prefilled", dict(n=10, pages_held=2, slot=1)),
    (1, "decode", dict(n=2, pages_held=2, slot=1)),
    (0, "finished", dict(n=3, pages_held=0)),
    (2, "enqueued", {}), (2, "timeout", dict(n=0, pages_held=0)),
    (2, "enqueued", {"retry_delay_ms": 25.0}),
    (2, "admitted", dict(n=5, pages_held=1, slot=0, resumed=False)),
    (2, "prefilled", dict(n=5, pages_held=1, slot=0)),
    (2, "first_token", dict(n=1, pages_held=1, slot=0)),
    (2, "crashed", dict(n=1, pages_held=0)),
    (2, "recovered", {"cause": "crashed"}),
    (2, "enqueued", {"cause": "recovered:crashed"}),
    (1, "quarantined", dict(n=2, pages_held=0)),
    (2, "admitted", dict(n=5, pages_held=1, slot=0, resumed=False)),
    (2, "prefilled", dict(n=5, pages_held=1, slot=0)),
    (2, "first_token", dict(n=1, pages_held=1, slot=0)),
    (2, "finished", dict(n=1, pages_held=0)),
    (7, "point_enqueued", {"lam": 0.5}),
    (7, "point_started", {"lam": 0.5, "warm": False}),
    (7, "point_finished", {"steps": 4, "plan": "ab12"}),
    (8, "point_enqueued", {"lam": 4.0}),
    (8, "point_loaded", {"plan": "cd34"}),
]


def _trace_run(mod, replica):
    reg = mod.MetricsRegistry()
    tr = mod.RequestTracer(reg, replica=replica)
    for uid, kind, fields in _LIFECYCLE:
        tr.event(uid, kind, **fields)
    return reg, tr


@pytest.mark.parametrize("replica", [None, "w8"])
def test_tracer_calls_give_identical_trace_and_metrics(replica):
    with counting_clocks(jtracing, ttracing):
        jr, jt = _trace_run(jobs, replica)
        tr_, tt = _trace_run(tobs, replica)
    assert tobs.trace_to_jsonl(tt) == jobs.trace_to_jsonl(jt)
    assert tobs.to_prometheus(tr_) == jobs.to_prometheus(jr)
    assert tobs.run_summary(tt, tr_) == jobs.run_summary(jt, jr)
    for uid in (0, 1, 2, 7, 8):
        assert tt.lifecycle(uid) == jt.lifecycle(uid)
    assert (tt.preemption_count(), tt.pages_held_hwm()) == \
        (jt.preemption_count(), jt.pages_held_hwm())
    # start() resets the trace, not the metrics; rebase moves the origin
    for t, r in ((jt, jr), (tt, tr_)):
        t.rebase(0.0)
        t.start()
        assert t.events == []
    assert tobs.to_prometheus(tr_) == jobs.to_prometheus(jr)


def test_event_grammar_constants_match():
    for name in ("EVENT_KINDS", "FAULT_TERMINAL_KINDS", "SWEEP_KINDS",
                 "TERMINAL_KINDS"):
        assert getattr(tobs, name) == getattr(jobs, name), name
    with pytest.raises(ValueError, match="unknown trace event kind"):
        tobs.RequestTracer().event(0, "teleported")


@pytest.mark.parametrize("kinds", [
    ["enqueued", "admitted", "prefilled", "first_token", "finished"],
    ["enqueued", "admitted", "prefilled", "first_token", "decode",
     "preempted", "admitted", "prefilled", "decode", "finished"],
    ["enqueued", "timeout", "enqueued", "admitted", "prefilled",
     "first_token", "finished"],
    ["enqueued", "admitted", "crashed", "recovered", "enqueued",
     "admitted", "prefilled", "first_token", "finished"],
    ["enqueued", "crashed", "recovered"],
    ["enqueued", "admitted", "recovered"],
    ["admitted", "finished"],
    ["enqueued", "first_token"],
    ["enqueued", "finished", "enqueued"],
    ["point_enqueued", "point_started", "point_finished"],
    ["point_enqueued", "point_loaded"],
    ["point_enqueued", "admitted"],
    [],
])
def test_lifecycle_verdicts_match(kinds):
    assert tobs.RequestTracer.check_lifecycle(kinds) == \
        jobs.RequestTracer.check_lifecycle(kinds)


# ---------------------------------------------------------------------------
# validate
# ---------------------------------------------------------------------------

def _good_files(tmp_path):
    with counting_clocks(ttracing):
        reg, tr = _trace_run(tobs, "a")
    m, t = tmp_path / "m.prom", tmp_path / "t.jsonl"
    tobs.write_prometheus(reg, str(m))
    tobs.write_trace(tr, str(t))
    return m, t


def _break(m, t, how):
    lines = t.read_text().splitlines()
    if how == "kind":
        ev = json.loads(lines[0])
        ev["kind"] = "teleported"
        lines[0] = json.dumps(ev)
    elif how == "missing_t":
        ev = json.loads(lines[1])
        del ev["t"]
        lines[1] = json.dumps(ev)
    elif how == "lifecycle":
        lines = [ln for ln in lines if '"admitted"' not in ln]
    elif how == "not_json":
        lines[2] = lines[2][:-3]
    elif how == "orphan":
        m.write_text(m.read_text() + "orphan_metric 1\n")
    elif how == "buckets":
        m.write_text("# TYPE h histogram\nh_bucket{le=\"1\"} 5\n"
                     "h_bucket{le=\"+Inf\"} 3\nh_sum 1\nh_count 3\n")
    t.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("how", ["none", "kind", "missing_t", "lifecycle",
                                 "not_json", "orphan", "buckets"])
def test_validate_verdicts_match(tmp_path, how):
    m, t = _good_files(tmp_path)
    if how != "none":
        _break(m, t, how)
    args = (str(m), str(t), SCHEMA)
    want = jvalidate.validate_files(*args)
    assert tvalidate.validate_files(*args) == want
    assert (want == []) == (how == "none")
    argv = ["--metrics", str(m), "--trace", str(t), "--schema", SCHEMA]
    assert tvalidate.main(argv) == jvalidate.main(argv)


def test_port_schema_copy_is_the_reference_schema():
    """``chip_smoke.py`` validates against the port's copy of the schema
    (it reads nothing of the JAX package)."""
    with open(SCHEMA) as f:
        want = json.load(f)
    with open(tvalidate.SCHEMA_PATH) as f:
        assert json.load(f) == want


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

LENS = (6, 14, 9, 21)
SERVER_KW = dict(max_len=48, max_batch=2, cache="paged", page_size=8,
                 pages=6)


@pytest.fixture(scope="module")
def world():
    cfg = jreg.get("llama3.2-1b-smoke")
    jp = jlm.init_params(cfg, jax.random.key(0))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp),
                            cfg=treg.get("llama3.2-1b-smoke"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=s).astype(np.int32)
               for s in LENS]
    return cfg, jp, tp, prompts


def _reqs(req_cls, sp_cls, prompts, sp):
    # streaming arrivals: one request every 2 decode steps
    return [req_cls(uid=i, prompt=p, sampling=sp_cls(**sp), arrival=2 * i)
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("case", ["float_greedy", "float_sampled",
                                  "plan_greedy"])
def test_server_events_and_metrics_match_jax(world, case):
    cfg, jp, tp, prompts = world
    sp = dict(max_tokens=10) if case != "float_sampled" else dict(
        temperature=0.8, top_k=12, max_tokens=10, seed=11)
    plan_on = case == "plan_greedy"
    with jax_k1_plain():
        jplan = jeng.synthetic_plan(cfg, jp, bits=8) if plan_on else None
        jsrv = jeng.InferenceServer(cfg, jp, plan=jplan,
                                    obs=jobs.Observability(), **SERVER_KW)
        jout = jsrv.serve(_reqs(JReq, JSP, prompts, sp))
    tplan = teng.synthetic_plan(cfg, tp, bits=8) if plan_on else None
    tsrv = teng.InferenceServer(cfg, tp, plan=tplan, device="cpu",
                                obs=tobs.Observability(), **SERVER_KW)
    tout = tsrv.serve(_reqs(TReq, TSP, prompts, sp))
    assert jsrv.stats["preemptions"] > 0        # the pool forces one
    assert tsrv.stats["preemptions"] == jsrv.stats["preemptions"]
    for uid in jout:
        np.testing.assert_array_equal(tout[uid], jout[uid])
    jt, tt = jsrv.obs.tracer, tsrv.obs.tracer
    for uid in range(len(LENS)):
        assert events_without_t(tt.events_for(uid)) == \
            events_without_t(jt.events_for(uid)), uid
    assert events_without_t(tt.events) == events_without_t(jt.events)
    assert obs_values(tsrv.obs.registry) == obs_values(jsrv.obs.registry)
    tsum, jsum = (s.metrics_snapshot()["summary"] for s in (tsrv, jsrv))
    for k in ("requests", "tokens", "preemptions", "pages_held_hwm",
              "decode_width_steps", "decode_compiles_per_width",
              "topk_sort_skip_rate"):
        assert tsum.get(k) == jsum.get(k), k


def test_launch_serve_artifacts_pass_the_reference_validator(tmp_path,
                                                             capsys):
    """``launch/serve.py --metrics --trace`` (paged, streaming arrivals)
    writes files the JAX package's validator accepts unchanged."""
    from repro_torch.launch import serve
    m, t = str(tmp_path / "m.prom"), str(tmp_path / "t.jsonl")
    serve.main(["--device", "cpu", "--plan", "demo", "--cache", "paged",
                "--page-size", "8", "--requests", "3", "--tokens", "4",
                "--stream", "--metrics", m, "--trace", t])
    out = capsys.readouterr().out
    assert "[obs] ttft" in out and "[obs] trace" in out
    assert jvalidate.validate_files(m, t, SCHEMA) == []
    with open(m) as f:
        text = f.read()
    for name in ("serve_requests_total", "serve_decode_steps_total",
                 "serve_pool_exhausted_total", "serve_cache_pages_in_use"):
        assert f"# TYPE {name} " in text, name
