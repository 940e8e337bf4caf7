"""The port's multi-replica fleet (``repro_torch.fleet``,
``repro_torch.launch.fleet``) against the JAX package's ``repro.fleet``
on the CPU.

Both fleets are built by their launchers' ``build_fleet`` from the same
(carried-across) ``llama3.2-1b-smoke`` weights: tiers ``float,w8,demo``,
``max_batch`` 2, a paged cache of 8-token pages.  Each is built once and
reused across policies through ``set_policy`` (the JAX fleet compiles one
server per tier; its planned projections run K1's plain reference,
bitwise equal to the interpret-mode kernel at these widths).  Every run
drives both fleets with the same trace, so their cumulative registries
stay in step.

Each run gives, in both packages: identical request records (status,
replica, attempts with their causes and virtual times, tokens), identical
SLO reports, identical per-replica trace event sequences with the wall
clock ``t`` left out, the same merged ``trace_events()`` as a multiset
(their order is by wall ``t``), and the same counter and gauge values and
histogram counts.  Every finished stream equals the same request served
alone by a fresh server of the tier that finished it (the reference's
oracle).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro import chaos as jchaos
from repro import fleet as jfleet
from repro.configs import registry as jreg
from repro.launch import fleet as jlaunch
from repro.models import lm as jlm
from repro.obs import validate as jvalidate
from repro_torch import chaos as tchaos
from repro_torch import fleet as tfleet
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import registry as treg
from repro_torch.launch import fleet as tlaunch
from repro_torch.serve import engine as teng

from torch_parity import events_without_t, jax_k1_plain, obs_values
from torch_threads import _one_torch_thread  # noqa: F401

ARCH = "llama3.2-1b-smoke"
TIERS = ["float", "w8", "demo"]
FLEET_KW = dict(max_len=64, max_batch=2, cache="paged", page_size=8,
                pages=None, base_step_ms=8.0)
CHAOS = "crash+slow+nan_plan+pool_pressure"
SCHEMA = "tests/obs_schema.json"


@pytest.fixture(scope="module")
def world():
    """Both fleets, and one solo server per tier for the oracle.  The
    JAX package's K1 stays on its plain reference for the module."""
    jcfg, tcfg = jreg.get(ARCH), treg.get(ARCH)
    jp = jlm.init_params(jcfg, jax.random.key(0))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg=tcfg)
    with jax_k1_plain():
        jf = jlaunch.build_fleet(jcfg, jp, TIERS, policy="round_robin",
                                 **FLEET_KW)
        tf = tlaunch.build_fleet(tcfg, tp, TIERS, policy="round_robin",
                                 device="cpu", **FLEET_KW)
        kw = {k: v for k, v in FLEET_KW.items() if k != "base_step_ms"}
        solo = {rep.tier.name: teng.InferenceServer(
            tcfg, tp, plan=rep.tier.plan, device="cpu", **kw)
            for rep in tf.replicas}
        yield jcfg, tcfg, jf, tf, solo


def _trace(mod, cfg, kind, n=12):
    common = dict(vocab=cfg.vocab, prompt_len=6, max_tokens=6,
                  deadline_ms=70.0, seed=3)
    if kind == "poisson":
        return mod.poisson_trace(n, rate_rps=150.0, **common)
    return mod.burst_trace(3, n // 3, burst_every_ms=40.0, **common)


def _record(r) -> dict:
    return {"uid": r.fr.uid, "status": r.status, "replica": r.replica,
            "first_token_ms": r.first_token_ms, "finish_ms": r.finish_ms,
            "tokens": None if r.tokens is None else r.tokens.tolist(),
            "degraded": r.degraded, "deadline_abs": r.deadline_abs,
            "sla_deadline_abs": r.sla_deadline_abs,
            "retries_used": r.fr.retries_used,
            "attempts": [dataclasses.asdict(a) for a in r.attempts]}


def _observed(flt, records, mod) -> dict:
    merged = sorted(json.dumps(d, sort_keys=True)
                    for d in events_without_t(flt.trace_events()))
    return {
        "records": {u: _record(r) for u, r in sorted(records.items())},
        "slo": mod.slo_report(flt, records),
        "events": {rep.tier.name: events_without_t(
            rep.server.obs.tracer.events) for rep in flt.replicas},
        "merged": merged,
        "metrics": obs_values(flt.registry),
        "health": flt.health.states(),
        "now": flt.now,
    }


def _run_both(world, policy, kind, chaos=None, failover=True):
    jcfg, tcfg, jf, tf, _ = world
    out = {}
    for key, flt, mod, chaos_mod, cfg in (
            ("jax", jf, jfleet, jchaos, jcfg),
            ("port", tf, tfleet, tchaos, tcfg)):
        flt.set_policy(policy)
        flt.failover = failover
        trace = _trace(mod, cfg, kind)
        flt.chaos = None
        if chaos is not None:
            sched = chaos_mod.parse_chaos(
                chaos, targets=TIERS, seed=5,
                horizon_ms=trace[-1].arrival_ms + 40.0)
            flt.chaos = chaos_mod.ChaosInjector(sched)
        out[key] = _observed(flt, flt.run(trace), mod)
    return out


def _check(world, got):
    jax_side, port = got["jax"], got["port"]
    for key in ("records", "slo", "events", "merged", "metrics",
                "health", "now"):
        assert port[key] == jax_side[key], key
    # the oracle: each finished stream is its tier's solo stream
    tf, solo = world[3], world[4]
    for fr_uid, rec in port["records"].items():
        if rec["status"] != "finished":
            continue
        req = next(r.fr.request for r in tf.records.values()
                   if r.fr.uid == fr_uid)
        alone = solo[rec["replica"]].serve([req])[fr_uid]
        assert rec["tokens"] == alone.tolist(), fr_uid


@pytest.mark.parametrize("kind", ["poisson", "burst"])
@pytest.mark.parametrize("policy", ["round_robin", "least_loaded",
                                    "pareto_degrade", "static:w8"])
def test_fleet_runs_match_jax(world, policy, kind):
    got = _run_both(world, policy, kind)
    _check(world, got)
    recs = got["port"]["records"].values()
    assert all(r["status"] in ("finished", "timeout", "cancelled", "shed")
               for r in recs)
    if policy == "pareto_degrade":
        assert any(r["degraded"] for r in recs)
    if policy == "static:w8":
        assert {r["replica"] for r in recs} <= {"w8"}


@pytest.mark.parametrize("failover", [True, False])
def test_fleet_chaos_runs_match_jax(world, failover):
    got = _run_both(world, "pareto_degrade", "poisson", chaos=CHAOS,
                    failover=failover)
    _check(world, got)
    port = got["port"]
    kinds = {dict(k[1]).get("kind") for k in port["metrics"]
             if k[0] == "fault_injected_total"}
    assert kinds == {"crash", "slow", "nan_plan", "pool_pressure"}
    nan = sum(v for k, v in port["metrics"].items()
              if k[0] == "fault_nan_detected_total")
    assert nan >= 1
    causes = [a["cause"] for r in port["records"].values()
              for a in r["attempts"]]
    statuses = {r["status"] for r in port["records"].values()}
    if failover:
        assert any(c.startswith("recovered:") for c in causes)
    else:
        assert not any(c.startswith("recovered:") for c in causes)
        assert statuses & {"crashed", "quarantined"}


def test_launch_fleet_artifacts_pass_the_reference_validator(tmp_path,
                                                             capsys):
    m, t, r = (str(tmp_path / n) for n in ("m.prom", "t.jsonl", "r.json"))
    report = tlaunch.main([
        "--device", "cpu", "--arch", ARCH, "--tiers", "float,w8,demo",
        "--requests", "8", "--chaos", "crash+slow", "--chaos-seed", "7",
        "--metrics", m, "--trace", t, "--report", r])
    out = capsys.readouterr().out
    assert "modelled" in out and "[obs] trace" in out
    assert jvalidate.validate_files(m, t, SCHEMA) == []
    assert jvalidate.main(["--metrics", m, "--trace", t,
                           "--schema", SCHEMA]) == 0
    with open(r) as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert sum(report["status"].values()) == 8


def test_tier_grammar_matches_jax(world):
    """``w<bits>`` / ``demo`` / ``mixed`` / ``float`` give the reference's
    tiers (mean bits and modelled step cost), and the launchers refuse
    the same specs."""
    jcfg, tcfg, jf, tf, _ = world
    jp = jf.replicas[0].server.params
    tp = tf.replicas[0].server.params
    for spec in ("float", "w8", "w4", "w2", "demo", "mixed"):
        jt = jlaunch.build_tier(spec, jcfg, jp, 8.0)
        tt = tlaunch.build_tier(spec, tcfg, tp, 8.0)
        assert (tt.name, tt.quality, tt.step_ms) == \
            (jt.name, jt.quality, jt.step_ms), spec
    assert tfleet.plan_mean_bits(None) == 16.0
    for mod, cfg, p in ((jlaunch, jcfg, jp), (tlaunch, tcfg, tp)):
        with pytest.raises(ValueError, match="duplicate tier names"):
            mod.build_fleet(cfg, p, ["float", "float"],
                            policy="round_robin",
                            **{**FLEET_KW, "cache": "dense"},
                            **({"device": "cpu"} if mod is tlaunch
                               else {}))
    with pytest.raises(ValueError):
        tfleet.make_router("fastest_first", tf)
    with pytest.raises(KeyError):
        tfleet.make_router("static:nope", tf)


@pytest.mark.parametrize("kind", ["poisson", "burst"])
def test_load_generators_match_jax(kind):
    """The same arrival times, prompts, sampling, deadlines and budgets
    in both packages."""
    cfg = treg.get(ARCH)
    kw = dict(vocab=cfg.vocab, prompt_len=7, max_tokens=5,
              deadline_ms=50.0, retry_budget=2, preempt_budget=1,
              temperature=0.7, top_k=5, seed=9, uid0=40)
    if kind == "poisson":
        gen = lambda mod: mod.poisson_trace(10, rate_rps=75.0, **kw)
    else:
        gen = lambda mod: mod.burst_trace(3, 4, burst_every_ms=30.0, **kw)

    def flat(trace):
        return [(fr.uid, fr.arrival_ms, fr.deadline_ms, fr.retry_budget,
                 fr.preempt_budget, fr.request.prompt.tolist(),
                 dataclasses.astuple(fr.request.sampling))
                for fr in trace]
    assert flat(gen(tfleet)) == flat(gen(jfleet))
    with pytest.raises(ValueError, match="rate_rps"):
        tfleet.poisson_trace(1, rate_rps=0.0, vocab=8)
