"""Open-loop load generation + SLO attainment reporting.

Open-loop means arrivals do not wait for completions: request *i*
arrives at its trace time whether or not the fleet has drained request
*i-1*, which is what exposes queueing collapse (closed-loop harnesses
famously hide it by self-throttling).  Arrival times are virtual
milliseconds on the fleet's modeled clock, so traces are deterministic
given a seed and identical on any machine.

``slo_report`` turns a finished run's ``RequestRecord`` map into the
numbers the bench and CLI print: overall + per-tier p50/p95/p99 TTFT
and per-token latency (virtual ms), deadline attainment, and the
shed / timeout / degrade / retry counts.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs import percentiles
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Request
from repro_torch.fleet.fleet import FleetRequest


def _mk_request(uid: int, rng, vocab: int, prompt_len: int,
                sampling: SamplingParams) -> Request:
    prompt = rng.integers(0, vocab, size=prompt_len).astype(np.int32)
    return Request(uid=uid, prompt=prompt, sampling=sampling)


def poisson_trace(n_requests: int, *, rate_rps: float, vocab: int,
                  prompt_len: int = 8, max_tokens: int = 8,
                  deadline_ms: float | None = None,
                  retry_budget: int = 1, preempt_budget: int = 3,
                  temperature: float = 0.0, top_k: int = 0,
                  seed: int = 0, uid0: int = 0) -> list:
    """Open-loop Poisson arrivals: exponential inter-arrival gaps at
    ``rate_rps`` requests per (virtual) second, seeded prompts."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    rng = np.random.default_rng(seed)
    sampling = SamplingParams(temperature=temperature, top_k=top_k,
                              max_tokens=max_tokens, seed=seed)
    t, out = 0.0, []
    for i in range(n_requests):
        t += float(rng.exponential(1000.0 / rate_rps))
        out.append(FleetRequest(
            request=_mk_request(uid0 + i, rng, vocab, prompt_len,
                                sampling),
            arrival_ms=t, deadline_ms=deadline_ms,
            retry_budget=retry_budget, preempt_budget=preempt_budget))
    return out


def burst_trace(n_bursts: int, burst_size: int, *,
                burst_every_ms: float, vocab: int, prompt_len: int = 8,
                max_tokens: int = 8, deadline_ms: float | None = None,
                retry_budget: int = 1, preempt_budget: int = 3,
                temperature: float = 0.0, top_k: int = 0,
                seed: int = 0, uid0: int = 0) -> list:
    """Synchronized bursts: ``burst_size`` simultaneous arrivals every
    ``burst_every_ms`` -- the adversarial pattern for queue-wait
    prediction (Poisson is the friendly one)."""
    rng = np.random.default_rng(seed)
    sampling = SamplingParams(temperature=temperature, top_k=top_k,
                              max_tokens=max_tokens, seed=seed)
    out = []
    uid = uid0
    for b in range(n_bursts):
        t = b * float(burst_every_ms)
        for _ in range(burst_size):
            out.append(FleetRequest(
                request=_mk_request(uid, rng, vocab, prompt_len,
                                    sampling),
                arrival_ms=t, deadline_ms=deadline_ms,
                retry_budget=retry_budget,
                preempt_budget=preempt_budget))
            uid += 1
    return out


def slo_report(fleet, records: dict) -> dict:
    """SLO attainment + latency percentiles for one finished run.

    All latencies are virtual milliseconds.  TTFT is first token of the
    *successful* attempt minus trace arrival (a retried request's
    discarded partial stream does not count as delivery); per-token
    latency is the finished stream's mean inter-token gap.  Deadline
    attainment counts sheds/timeouts/evictions as misses -- an SLO is
    about what the client got.
    """
    per_tier: dict = {rep.tier.name: {"requests": 0, "ttft_ms": [],
                                      "token_ms": [], "met": 0,
                                      "with_deadline": 0}
                      for rep in fleet.replicas}
    status = {"finished": 0, "shed": 0, "timeout": 0, "cancelled": 0,
              "queued": 0, "running": 0}
    met = with_deadline = degraded = retries = 0
    for rec in records.values():
        status[rec.status] = status.get(rec.status, 0) + 1
        degraded += bool(rec.degraded)
        retries += rec.fr.retries_used
        if rec.fr.deadline_ms is not None:
            with_deadline += 1
            met += bool(rec.deadline_met)
        tier = per_tier.get(rec.replica)
        if tier is None or rec.status != "finished":
            continue
        tier["requests"] += 1
        if rec.fr.deadline_ms is not None:
            tier["with_deadline"] += 1
            tier["met"] += bool(rec.deadline_met)
        if rec.first_token_ms is not None:
            tier["ttft_ms"].append(rec.first_token_ms - rec.fr.arrival_ms)
        n = 0 if rec.tokens is None else len(rec.tokens)
        if n > 1 and rec.first_token_ms is not None:
            tier["token_ms"].append(
                (rec.finish_ms - rec.first_token_ms) / (n - 1))
    out_tiers = {}
    for name, t in per_tier.items():
        out_tiers[name] = {
            "requests": t["requests"],
            "ttft_ms": percentiles(t["ttft_ms"]),
            "token_latency_ms": percentiles(t["token_ms"]),
            "deadline_attainment": (t["met"] / t["with_deadline"]
                                    if t["with_deadline"] else None),
        }
    all_ttft = [x for t in per_tier.values() for x in t["ttft_ms"]]
    all_tok = [x for t in per_tier.values() for x in t["token_ms"]]
    return {
        "requests": len(records),
        "status": status,
        "deadline_attainment": (met / with_deadline
                                if with_deadline else None),
        "degraded": degraded,
        "retries": retries,
        "ttft_ms": percentiles(all_ttft),
        "token_latency_ms": percentiles(all_tok),
        "per_tier": out_tiers,
    }
