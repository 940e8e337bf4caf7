"""Multi-replica serving: the Pareto front, operationalized.

A :class:`Fleet` owns N :class:`~repro_torch.serve.engine.InferenceServer`
replicas, each bound to one *plan tier* -- points on the accuracy/cost
Pareto front the compression search produces (float / 8-bit / mixed /
2-bit from the same run).  A pluggable router (see
:mod:`repro_torch.fleet.router`) picks the replica per request; the
``pareto_degrade`` policy routes to the highest-quality tier whose
predicted completion keeps the request inside its deadline, degrading
to lower-bit replicas only under pressure and recovering when load
drops.

**Virtual time.**  The fleet advances a modeled clock in milliseconds:
each tier declares a per-decode-step cost ``step_ms`` (derived from its
plan's mean channel bits -- fewer bits, cheaper steps, the paper's cost
axis), and one engine ``step()`` advances that replica by ``step_ms``.
Token *content* is real -- every replica runs its actual decode kernels,
so a request's stream is byte-identical to a solo server with that
replica's plan -- while *latency* is modeled, which makes deadline
behavior deterministic and machine-independent, and the same in this
package as in the JAX package's fleet.  Every latency the fleet reports
(TTFT, token latency, deadlines) is on this modeled clock, not the
card's; ``chip_smoke.py`` prints each tier's real wall ms per decode
step beside its modeled ``step_ms``.  Deadline admission, timeout
cancellation (freeing cache pages, ``timeout`` lifecycle event), bounded
retry and preemption budgets, and the SLO report in
:mod:`repro_torch.fleet.loadgen` all work in this virtual clock.

**Faults and failover.**  The fleet accepts a
:class:`~repro_torch.chaos.ChaosInjector` whose schedule it replays on the
same virtual clock (``--chaos`` in ``launch.fleet``): replica crashes
and NaN-plan quarantines *strike* a replica -- every in-flight request
is cancelled with a ``crashed``/``quarantined`` terminal, the session
closed, and (with ``failover=True``) recovered recompute-style onto
survivors, front-of-queue so FCFS seniority holds.  Because a request's
sampling stream is a pure function of ``(seed, uid, token_index)``, the
recovered stream is byte-identical to the fault-free run.  A
:class:`~repro_torch.fleet.health.HealthMonitor` detects failures
observationally (dead heartbeat, watchdog step spacing, pool
starvation) and gates struck replicas behind a warm-up probe before
routers see them again.  Timeout/preemption retries back off
exponentially (bounded, virtual clock) before re-dispatch.

Observability: replicas share one :class:`MetricsRegistry` (fleet
counters + per-replica queue series keyed by the ``replica`` label) and
each carries its own :class:`RequestTracer`; :meth:`Fleet.trace_events`
merges the per-replica traces into one globally-ordered stream with a
``replica`` field per event.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Optional

import numpy as np

from repro_torch.obs import MetricsRegistry, Observability
from repro_torch.chaos.inject import poison_params
from repro_torch.fleet.health import HealthMonitor
from repro_torch.fleet.router import make_router
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Request

# warm-up probe uids live far above any realistic request uid so they
# never collide with routed traffic in a replica's session
PROBE_UID_BASE = 1_000_000_000


# ---------------------------------------------------------------------------
# tiers: plan -> (cost, quality) point
# ---------------------------------------------------------------------------

def plan_mean_bits(plan) -> float:
    """Mean per-channel bit-width across every group of a plan
    (pruned channels count as 0); float serving (``plan=None``) is 16."""
    if plan is None:
        return 16.0
    total = n = 0.0
    for bits in plan.channel_bits.values():
        b = np.asarray(bits, np.float64)
        total += float(b.sum())
        n += b.size
    return total / n if n else 16.0


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One Pareto-front point the fleet serves.

    ``step_ms`` is the modeled cost of one batched decode step on this
    tier's replica; ``quality`` orders tiers for the degrade policy
    (higher = better, mean channel bits by default)."""

    name: str
    plan: object                   # CompressionPlan or None (float)
    step_ms: float
    quality: float


def tier_from_plan(name: str, plan, base_step_ms: float = 8.0) -> TierSpec:
    """Model a tier's decode-step cost from its plan's mean bits.

    ``step_ms = base * (0.25 + 0.75 * bits/16)``: a float replica costs
    ``base`` per step, a fully 2-bit one ~0.34x of it -- a fixed
    scheduling/launch floor plus a weight-traffic term linear in bits,
    the same shape as the paper's size-proportional cost model."""
    bits = plan_mean_bits(plan)
    return TierSpec(name=name, plan=plan,
                    step_ms=base_step_ms * (0.25 + 0.75 * bits / 16.0),
                    quality=bits)


# ---------------------------------------------------------------------------
# requests + per-request accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetRequest:
    """One fleet-level request: an engine Request plus arrival time,
    deadline and retry budgets (all in virtual milliseconds)."""

    request: object                   # repro_torch.serve.scheduler.Request
    arrival_ms: float = 0.0
    deadline_ms: Optional[float] = None   # relative; None = no SLO
    retry_budget: int = 1             # re-dispatches after timeout/evict
    preempt_budget: int = 3           # preemptions tolerated per attempt
    retries_used: int = 0

    @property
    def uid(self) -> int:
        return self.request.uid


@dataclasses.dataclass
class Attempt:
    """One dispatch of a request onto a replica."""

    tier: str
    t_start: float
    cause: str = "arrival"    # arrival | retry:timeout | retry:preempt
    #                           | recovered:crashed | recovered:quarantined
    degraded: bool = False
    preempt_base: int = 0         # replica's preempt count at dispatch


@dataclasses.dataclass
class RequestRecord:
    """Everything the fleet knows about one request's journey."""

    fr: FleetRequest
    # per-attempt cancellation deadline: refreshed on retry so the
    # retry is not cancelled at birth...
    deadline_abs: Optional[float] = None
    # ...but the SLO is judged against the ORIGINAL promise (arrival +
    # deadline_ms): a timeout-retry that lands late is still a miss
    sla_deadline_abs: Optional[float] = None
    attempts: list = dataclasses.field(default_factory=list)
    # queued|running|retrying|finished|timeout|cancelled|shed, plus the
    # fault terminals crashed|quarantined when failover is off
    status: str = "queued"
    replica: Optional[str] = None    # current / final replica
    first_token_ms: Optional[float] = None
    finish_ms: Optional[float] = None
    tokens: Optional[np.ndarray] = None
    degraded: bool = False           # ever routed below the top tier

    @property
    def deadline_met(self) -> bool:
        """Finished, and inside the deadline (vacuously true without
        one).  Shed / timed-out / cancelled requests miss by definition
        when they carry a deadline."""
        if self.status != "finished":
            return False
        return (self.sla_deadline_abs is None
                or self.finish_ms <= self.sla_deadline_abs + 1e-9)


@dataclasses.dataclass
class Replica:
    """A tier-bound engine plus its virtual-clock + fault state."""

    tier: TierSpec
    server: object                 # InferenceServer
    busy_until: float = 0.0        # virtual ms when its current step ends
    down: bool = False             # session dead (crash / quarantine)
    down_cause: str = ""           # "crashed" | "quarantined"
    slow_factor: float = 1.0       # active slow-fault step multiplier
    nan_undo: object = None        # undo closure of an active nan_plan
    probe_uid: Optional[int] = None   # in-flight warm-up probe

    def heartbeat(self) -> Optional[dict]:
        """Host-side liveness signal the health monitor polls: the
        engine's ``load_report()``, or None when the session is dead.
        The monitor infers ``down`` from this -- faults are never
        reported to it directly."""
        if self.down:
            return None
        return self.server.load_report()


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

class Fleet:
    """N tier-bound replicas behind one router.

    ``replicas`` is a list of ``(TierSpec, InferenceServer)`` pairs; the
    fleet attaches a shared-registry Observability bundle to each (one
    metric namespace, per-replica tracers).  ``policy`` is a router name
    (``round_robin`` / ``least_loaded`` / ``pareto_degrade`` /
    ``static:<tier>``); :meth:`set_policy` swaps it between runs --
    replicas and their compiled decode paths are reused, which is how
    the bench compares policies on identical fleets.

    ``chaos`` is an optional :class:`~repro_torch.chaos.ChaosInjector` whose
    schedule the run loop replays (one injector per run -- its events
    deliver once).  ``health`` is the :class:`HealthMonitor` routers
    consult (a default is built on the shared registry).
    ``failover=False`` turns crash recovery off: a struck replica's
    requests die with the fault terminal -- the bench's ablation arm.
    ``retry_backoff_ms``/``retry_backoff_cap_ms`` bound the exponential
    backoff applied to timeout/preemption retries (virtual clock).
    """

    def __init__(self, replicas, *, policy: str = "round_robin",
                 metrics: bool = True, chaos=None, health=None,
                 failover: bool = True, retry_backoff_ms: float = 25.0,
                 retry_backoff_cap_ms: float = 400.0):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.registry = MetricsRegistry(enabled=metrics)
        self.replicas: list[Replica] = []
        for tier, server in replicas:
            server.attach_obs(Observability(registry=self.registry,
                                            replica=tier.name))
            self.replicas.append(Replica(tier=tier, server=server))
        names = [r.tier.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        self.chaos = chaos
        self.health = (health if health is not None
                       else HealthMonitor(registry=self.registry))
        self.failover = bool(failover)
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.retry_backoff_cap_ms = float(retry_backoff_cap_ms)
        self._retries: list = []    # (due_ms, RequestRecord, why, delay)
        self._probe_seq = 0
        self.records: dict[int, RequestRecord] = {}
        self.now = 0.0
        self.set_policy(policy)

    def set_policy(self, policy: str):
        self.policy = policy
        self.router = make_router(policy, self)

    def replica_by_name(self, name: str) -> Replica:
        for rep in self.replicas:
            if rep.tier.name == name:
                return rep
        raise KeyError(f"no replica {name!r} "
                       f"(have {[r.tier.name for r in self.replicas]})")

    # ------------------------------------------------------------- metrics
    def _count(self, name: str, help_: str, n: int = 1, **labels):
        if self.registry.enabled:
            self.registry.counter(
                name, help_,
                labels=tuple(labels) if labels else ()).inc(n, **labels)

    # ------------------------------------------------------------ the run
    def run(self, trace) -> dict:
        """Drive an arrival trace (iterable of :class:`FleetRequest`)
        to completion; returns ``{uid: RequestRecord}``.

        Virtual-time event loop: apply due chaos events, deliver
        arrivals due at ``now``, re-dispatch retries whose backoff
        expired, scan deadlines (timeout-cancel + backoff retry),
        observe replica health (issuing warm-up probes to recovering
        replicas), step every live replica whose previous step has
        finished, then jump ``now`` to the next event (arrival, step
        completion, retry due, or chaos event -- the clock lands *on*
        fault times, never over them).
        """
        for rep in self.replicas:
            rep.server.begin()
            rep.busy_until = 0.0
            rep.down = False
            rep.down_cause = ""
            rep.slow_factor = 1.0
            rep.nan_undo = None
            rep.probe_uid = None
        self._retries = []
        self._probe_seq = 0
        self.health.start([r.tier.name for r in self.replicas])
        t0 = time.perf_counter()
        for rep in self.replicas:       # one time origin -> merged trace
            tracer = rep.server.obs.tracer
            if tracer is not None:
                tracer.rebase(t0)

        pending = collections.deque(
            sorted(trace, key=lambda fr: (fr.arrival_ms, fr.uid)))
        records: dict[int, RequestRecord] = {}
        now = 0.0
        if pending:
            now = pending[0].arrival_ms
        while (pending or self._retries
               or any(rep.server.has_work for rep in self.replicas)):
            self._apply_chaos(now, records)
            while pending and pending[0].arrival_ms <= now + 1e-9:
                fr = pending.popleft()
                if fr.uid in records:
                    raise ValueError(f"duplicate fleet uid {fr.uid}")
                self._count("fleet_requests_total",
                            "Requests offered to the fleet")
                self._dispatch(fr, now, records, cause="arrival")
            self._retries.sort(key=lambda r: (r[0], r[1].fr.uid))
            while self._retries and self._retries[0][0] <= now + 1e-9:
                _, rec, why, delay = self._retries.pop(0)
                self._dispatch(rec.fr, now, records,
                               cause=f"retry:{why}",
                               trace_extra={"retry_delay_ms": delay})
            self._scan_deadlines(now, records)
            for rep in self.replicas:
                self.health.observe(rep, now)
                if (rep.probe_uid is None and not rep.down
                        and self.health.state(rep.tier.name)
                        == "warming"):
                    self._submit_probe(rep, now)
            for rep in self.replicas:
                if rep.down:
                    continue
                if rep.server.has_work and rep.busy_until <= now + 1e-9:
                    res = rep.server.step()
                    rep.busy_until = (now + rep.tier.step_ms
                                      * rep.slow_factor)
                    if res.nan:
                        # poisoned logits at the sampling boundary: the
                        # step's tokens were discarded; quarantine
                        self._strike(rep, now, records, "quarantined")
                    else:
                        self._after_step(rep, res, rep.busy_until,
                                         records, now)
            times = [pending[0].arrival_ms] if pending else []
            times.extend(due for due, *_ in self._retries)
            for rep in self.replicas:
                if not rep.down and rep.server.has_work:
                    times.append(rep.busy_until)
            if self.chaos is not None:
                # chaos alone does not keep the run alive, but while
                # work remains the clock must land ON fault times
                nt = self.chaos.next_time()
                if nt is not None and times:
                    times.append(nt)
            if not times:
                break
            now = max(now, min(times))

        self.now = now
        for rep in self.replicas:
            if rep.server._sched is not None:
                rep.server.end()
        self.records = records
        return records

    # -------------------------------------------------------- dispatching
    def _dispatch(self, fr: FleetRequest, now: float, records: dict,
                  cause: str, *, front: bool = False,
                  trace_extra: Optional[dict] = None):
        rec = records.get(fr.uid)
        if rec is None:
            rec = records[fr.uid] = RequestRecord(fr=fr)
        rep, degraded = self.router.route(fr, now)
        if rep is None:
            rec.status = "shed"
            rec.finish_ms = now
            self._count("fleet_shed_total",
                        "Requests rejected at routing (no tier could "
                        "meet the deadline)")
            return
        rep.server.submit(fr.request, front=front,
                          trace_extra=trace_extra)
        rec.status = "running"
        rec.replica = rep.tier.name
        rec.first_token_ms = None          # per-attempt: retries restart
        rec.deadline_abs = (None if fr.deadline_ms is None
                            else now + fr.deadline_ms)
        if rec.sla_deadline_abs is None and fr.deadline_ms is not None:
            rec.sla_deadline_abs = fr.arrival_ms + fr.deadline_ms
        rec.degraded = rec.degraded or degraded
        rec.attempts.append(Attempt(
            tier=rep.tier.name, t_start=now, cause=cause,
            degraded=degraded,
            preempt_base=rep.server.preemption_counts.get(fr.uid, 0)))
        self._count("fleet_routed_total",
                    "Requests dispatched to a replica, by tier",
                    tier=rep.tier.name)
        if degraded:
            self._count("fleet_degraded_total",
                        "Dispatches below the top-quality tier under "
                        "deadline pressure")

    # ----------------------------------------------------------- deadlines
    def _scan_deadlines(self, now: float, records: dict):
        for uid, rec in records.items():
            if rec.status != "running" or rec.deadline_abs is None:
                continue
            if now <= rec.deadline_abs + 1e-9:
                continue
            rep = self.replica_by_name(rec.replica)
            toks = rep.server.cancel(uid, reason="timeout")
            if toks is None:       # finished in the same instant
                continue
            self._count("fleet_timeouts_total",
                        "Deadline-exceeded cancellations, by tier",
                        tier=rep.tier.name)
            self._retry_or_fail(rec, now, records, "timeout")

    def _retry_or_fail(self, rec: RequestRecord, now: float,
                       records: dict, why: str):
        """Queue a bounded-exponential-backoff re-dispatch (virtual
        clock: ``min(base * 2**(retries_used-1), cap)``) or fail the
        request for good.  The delay rides on the re-dispatch's
        ``enqueued`` trace event as ``retry_delay_ms``."""
        fr = rec.fr
        if fr.retries_used < fr.retry_budget:
            fr.retries_used += 1
            delay = min(self.retry_backoff_ms
                        * (2.0 ** (fr.retries_used - 1)),
                        self.retry_backoff_cap_ms)
            self._count("fleet_retries_total",
                        "Re-dispatches after timeout or preemption-"
                        "budget eviction", cause=why)
            rec.status = "retrying"
            self._retries.append((now + delay, rec, why, delay))
        else:
            rec.status = "timeout" if why == "timeout" else "cancelled"
            rec.finish_ms = now
            if rec.deadline_abs is not None:
                self._count("fleet_deadline_missed_total",
                            "Requests that missed their deadline, by "
                            "tier", tier=rec.replica or "")

    # ------------------------------------------------------------- faults
    def _apply_chaos(self, now: float, records: dict):
        """Deliver every chaos event due at ``now`` to its host
        boundary: crash/quarantine strike the session, slow scales the
        modeled step cost, pool pressure withholds cache pages, and
        nan_plan poisons the bound params (the engine's NaN guard does
        the rest).  Restores undo the matching injection."""
        if self.chaos is None:
            return
        for phase, spec in self.chaos.due(now):
            if spec.kind == "store_corrupt":
                raise ValueError(
                    "store_corrupt faults target a PlanStore, not the "
                    "fleet; inject them with "
                    "repro_torch.chaos.corrupt_store_entry")
            rep = self.replica_by_name(spec.target)
            if phase == "inject":
                self._count("fault_injected_total",
                            "Chaos fault injections delivered, by kind",
                            kind=spec.kind)
                if spec.kind == "crash":
                    self._strike(rep, now, records, "crashed")
                elif spec.kind == "slow":
                    rep.slow_factor = spec.factor
                elif spec.kind == "pool_pressure":
                    rep.server.backend.shrink_pool(spec.pages)
                elif spec.kind == "nan_plan":
                    rep.nan_undo = poison_params(rep.server)
            else:                       # restore
                if spec.kind == "slow":
                    rep.slow_factor = 1.0
                elif spec.kind == "pool_pressure":
                    rep.server.backend.restore_pool()
                elif spec.kind in ("crash", "nan_plan"):
                    if rep.nan_undo is not None:
                        rep.nan_undo()
                        rep.nan_undo = None
                    if rep.down:
                        rep.down = False
                        rep.down_cause = ""
                        # reopen the session but keep the trace: the
                        # crashed/recovered history must survive
                        rep.server.begin(fresh_trace=False)
                        rep.busy_until = now
                        # the monitor sees the heartbeat return on its
                        # next observation -> warming -> probe

    def _strike(self, rep: Replica, now: float, records: dict,
                kind: str):
        """Kill a replica's session (``crashed`` or ``quarantined``):
        cancel every in-flight request with the fault terminal, close
        the session, and -- with failover on -- recover the requests
        recompute-style onto survivors.  Each victim gets a
        ``recovered`` marker on the struck replica's tracer, then a
        front-of-queue re-dispatch; front-pushing in reverse seniority
        order restores FCFS order on the survivor, and the per-uid
        sampling stream replays byte-identically."""
        name = rep.tier.name
        server = rep.server
        tracer = server.obs.tracer if server.obs is not None else None
        victims = []
        for uid in server.live_uids():       # FCFS seniority order
            server.cancel(uid, reason=kind)
            if uid == rep.probe_uid:
                self.health.probe_done(name, False, now)
                rep.probe_uid = None
                continue
            rec = records.get(uid)
            if rec is not None and rec.status == "running":
                victims.append(rec)
        server.end()
        rep.down = True
        rep.down_cause = kind
        rep.busy_until = now
        # mark down from the dead heartbeat BEFORE routing, so no
        # recovered request can land back on the struck replica
        self.health.observe(rep, now)
        for rec in reversed(victims):
            if not self.failover:
                rec.status = kind
                rec.finish_ms = now
                if rec.sla_deadline_abs is not None:
                    self._count("fleet_deadline_missed_total",
                                "Requests that missed their deadline, "
                                "by tier", tier=name)
                continue
            if tracer is not None:
                tracer.event(rec.fr.uid, "recovered", cause=kind)
            self._count("fault_recovered_requests_total",
                        "In-flight requests recovered off a struck "
                        "replica, by tier", tier=name)
            self._dispatch(rec.fr, now, records,
                           cause=f"recovered:{kind}", front=True,
                           trace_extra={"cause": f"recovered:{kind}"})

    def _submit_probe(self, rep: Replica, now: float):
        """Send a tiny greedy warm-up request through a warming
        replica; :meth:`_after_step` reports its completion to the
        health monitor, which re-admits the replica to routing."""
        uid = PROBE_UID_BASE + self._probe_seq
        self._probe_seq += 1
        req = Request(uid=uid,
                      prompt=np.array([1, 2, 3, 1], np.int32),
                      sampling=SamplingParams(max_tokens=2))
        rep.server.submit(req, trace_extra={"probe": True})
        rep.probe_uid = uid

    # ------------------------------------------------------- step results
    def _after_step(self, rep: Replica, res, t_done: float,
                    records: dict, now: float):
        name = rep.tier.name
        for uid, n_toks in res.produced.items():
            rec = records.get(uid)
            if (rec is not None and rec.status == "running"
                    and rec.replica == name
                    and rec.first_token_ms is None):
                rec.first_token_ms = t_done
        for uid in res.finished:
            if uid == rep.probe_uid:
                # warm-up probe came back: the replica is re-admitted
                self.health.probe_done(name, True, now)
                rep.probe_uid = None
                continue
            rec = records.get(uid)
            if rec is None or rec.replica != name \
                    or rec.status != "running":
                continue
            rec.status = "finished"
            rec.finish_ms = t_done
            rec.tokens = rep.server.result(uid)
            self._count("fleet_completed_total",
                        "Requests completed, by tier", tier=name)
            if rec.sla_deadline_abs is not None:
                met = t_done <= rec.sla_deadline_abs + 1e-9
                self._count(
                    "fleet_deadline_met_total" if met
                    else "fleet_deadline_missed_total",
                    "Requests that met their deadline, by tier" if met
                    else "Requests that missed their deadline, by tier",
                    tier=name)
        # preemption budget: a request thrashing in/out of the pool gets
        # evicted (cancelled) and re-routed instead of thrashing forever
        counts = rep.server.preemption_counts
        for uid, cnt in list(counts.items()):
            rec = records.get(uid)
            if rec is None or rec.status != "running" \
                    or rec.replica != name:
                continue
            base = rec.attempts[-1].preempt_base if rec.attempts else 0
            if cnt - base > rec.fr.preempt_budget:
                toks = rep.server.cancel(uid, reason="cancelled")
                if toks is None:
                    continue
                self._count("fleet_cancelled_total",
                            "Preemption-budget evictions, by tier",
                            tier=name)
                self._retry_or_fail(rec, now, records, "preempt")

    # ------------------------------------------------------ trace merging
    def trace_events(self) -> list:
        """All replica trace events merged into one globally-ordered
        stream; each event JSON gains a ``replica`` field."""
        evs = []
        for rep in self.replicas:
            tracer = (rep.server.obs.tracer
                      if rep.server.obs is not None else None)
            if tracer is None:
                continue
            for ev in tracer.events:
                d = ev.to_json()
                d["replica"] = rep.tier.name
                evs.append(d)
        evs.sort(key=lambda d: d["t"])
        return evs

    def write_trace(self, path: str):
        with open(path, "w") as f:
            for d in self.trace_events():
                f.write(json.dumps(d, sort_keys=True) + "\n")

    def metrics_snapshot(self) -> dict:
        return {"metrics": (self.registry.snapshot()
                            if self.registry.enabled else {}),
                "load": {rep.tier.name: rep.server.load_report()
                         for rep in self.replicas}}

    # -------------------------------------------------------- predictions
    def predicted_completion_ms(self, rep: Replica, fr: FleetRequest,
                                now: float) -> float:
        """Fluid-model ETA for ``fr`` on ``rep``: finish the current
        step, drain the backlog at ``max_batch`` tokens per step, then
        decode the request's own tokens one per step.  The per-step
        cost is inflated by the health monitor's observed slowdown, so
        a watchdog-degraded replica's ETAs are honest."""
        load = rep.server.load_report()
        backlog = load["queued_tokens"] + load["active_tokens"]
        own = int(fr.request.sampling.max_tokens)
        busy = max(0.0, rep.busy_until - now)
        step = (rep.tier.step_ms
                * self.health.eta_multiplier(rep.tier.name))
        return (now + busy + step
                * (backlog / rep.server.max_batch + own))
