"""Request lifecycle tracer for the serving engine.

Each request moving through :class:`repro_torch.serve.engine.InferenceServer`
leaves a trail of :class:`TraceEvent` records::

    enqueued -> admitted -> prefilled -> first_token -> decode(n)*
             -> (preempted -> admitted -> prefilled -> decode(n)* )*
             -> finished | timeout | cancelled

``timeout`` and ``cancelled`` are the cancellation terminals (the
engine's ``cancel()`` API frees the request's cache pages first); a
timed-out or cancelled uid may be *re-enqueued* -- the fleet layer's
retry path -- which starts a fresh episode of the same grammar.

Timestamps are monotonic (``time.perf_counter``) relative to the start
of the serve run, so event deltas are meaningful even across wall-clock
adjustments.  ``pages_held`` snapshots the cache pages a request holds
at the transition, which makes memory pressure attributable per request.

The tracer doubles as the feed for the latency histograms: when a
registry is attached, ``first_token`` observes ``serve_ttft_seconds``
and every token-bearing event observes ``serve_token_latency_seconds``,
so histogram counts reconcile exactly with the engine's token totals.
It also feeds the queue-side series: ``serve_queue_depth`` (requests
waiting for a slot, per ``replica`` label) and
``serve_queue_wait_seconds`` (enqueued->admitted, re-queues measured
from the preemption).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

EVENT_KINDS = ("enqueued", "admitted", "prefilled", "first_token",
               "decode", "preempted", "finished", "timeout", "cancelled",
               # fault-path lifecycle (repro_torch.chaos / fleet failover):
               # crashed/quarantined strike every request in flight on a
               # replica that died or started emitting NaN logits;
               # recovered marks the failover re-enqueue onto a survivor
               "crashed", "quarantined", "recovered",
               # sweep-point lifecycle (repro_torch.sweep): a search point is
               # enqueued, then either loaded from the plan store or
               # started (warm or cold) and finished into the store
               "point_enqueued", "point_started", "point_loaded",
               "point_finished")
# events that end a residency episode for a uid (a timeout/cancelled/
# crashed/quarantined uid may be re-enqueued by the fleet's retry or
# failover path; finished is final)
TERMINAL_KINDS = ("finished", "timeout", "cancelled", "crashed",
                  "quarantined")
# the fault-struck subset of TERMINAL_KINDS: episodes ended by one of
# these may be followed by a `recovered` marker before the re-enqueue
FAULT_TERMINAL_KINDS = ("crashed", "quarantined")
# the sweep-point subset: a uid uses either the serve grammar or the
# sweep grammar, never a mix
SWEEP_KINDS = ("point_enqueued", "point_started", "point_loaded",
               "point_finished")


@dataclass
class TraceEvent:
    """One lifecycle transition for one request."""

    uid: int
    kind: str
    t: float                       # seconds since tracer start (monotonic)
    n: int | None = None           # tokens: prompt size / generated so far
    pages_held: int | None = None  # cache pages held after the transition
    slot: int | None = None        # batch slot while resident
    extra: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        out = {"uid": self.uid, "kind": self.kind, "t": self.t}
        for k in ("n", "pages_held", "slot"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        out.update(self.extra)
        return out


class RequestTracer:
    """Accumulates lifecycle events for one serve run.

    ``start()`` resets the event log and the time origin; the attached
    registry (if any) is *not* reset, so metrics stay cumulative across
    runs while the trace is per-run.
    """

    def __init__(self, registry=None, replica=None):
        self.registry = registry if (registry is not None
                                     and registry.enabled) else None
        # fleet replicas share one registry; the replica tag keys the
        # queue-side series so per-replica depth/wait stay separable
        # (solo servers use the empty tag)
        self.replica = "" if replica is None else str(replica)
        self.events: list[TraceEvent] = []
        self._t0 = time.perf_counter()
        self._enq_t: dict[int, float] = {}
        self._last_token_t: dict[int, float] = {}
        self._queued: dict[int, float] = {}   # uid -> queue-entry time

    def start(self):
        self.events = []
        self._t0 = time.perf_counter()
        self._enq_t = {}
        self._last_token_t = {}
        self._queued = {}

    def rebase(self, t0: float):
        """Move the time origin to ``t0`` (a ``time.perf_counter``
        value).  The fleet rebases every replica tracer to one shared
        origin right after starting them, so the merged multi-replica
        trace is globally ordered by ``t``."""
        self._t0 = t0

    # ------------------------------------------------------------ recording
    def event(self, uid: int, kind: str, *, n=None, pages_held=None,
              slot=None, **extra):
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown trace event kind {kind!r}")
        t = time.perf_counter() - self._t0
        ev = TraceEvent(int(uid), kind, t,
                        n=None if n is None else int(n),
                        pages_held=(None if pages_held is None
                                    else int(pages_held)),
                        slot=None if slot is None else int(slot),
                        extra=extra)
        self.events.append(ev)

        if kind in SWEEP_KINDS:
            # sweep points carry none of the serve-side queue/latency
            # semantics: record the event and count it, nothing else
            if self.registry is not None:
                self.registry.counter(
                    "sweep_trace_events_total",
                    "Sweep-point lifecycle events recorded",
                    labels=("kind",)).inc(kind=kind)
            return ev

        if kind == "enqueued":
            self._enq_t[ev.uid] = t
            self._last_token_t.pop(ev.uid, None)

        reg = self.registry
        if reg is not None:
            reg.counter("serve_trace_events_total",
                        "Lifecycle trace events recorded",
                        labels=("kind",)).inc(kind=kind)
        # queue-side series: depth counts requests waiting for a decode
        # slot (enqueued or preempted back to the queue); wait is
        # queue-entry -> admitted, so re-queues measure from preemption
        if kind in ("enqueued", "preempted"):
            self._queued[ev.uid] = t
        elif kind == "admitted":
            entered = self._queued.pop(ev.uid, None)
            if reg is not None:
                reg.histogram(
                    "serve_queue_wait_seconds",
                    "Queue wait from enqueue (or re-queue on "
                    "preemption) to admission into a decode slot",
                    labels=("replica",)).observe(
                    t - (t if entered is None else entered),
                    replica=self.replica)
        elif kind in ("timeout", "cancelled", "crashed", "quarantined"):
            self._queued.pop(ev.uid, None)
        if reg is not None and kind in ("enqueued", "admitted",
                                        "preempted", "timeout",
                                        "cancelled", "crashed",
                                        "quarantined"):
            reg.gauge("serve_queue_depth",
                      "Requests waiting for a decode slot",
                      labels=("replica",)).set(len(self._queued),
                                               replica=self.replica)
        if kind in ("first_token", "decode"):
            # Every generated token passes through exactly one of these
            # events, so serve_token_latency_seconds' count equals the
            # engine's generated-token total.  The first token's latency
            # is measured from enqueue, later ones from the previous
            # token (including time spent preempted).
            prev = self._last_token_t.get(
                ev.uid, self._enq_t.get(ev.uid, t))
            if reg is not None:
                if kind == "first_token":
                    reg.histogram(
                        "serve_ttft_seconds",
                        "Time from enqueue to first generated token"
                    ).observe(t - self._enq_t.get(ev.uid, t))
                reg.histogram(
                    "serve_token_latency_seconds",
                    "Per-generated-token latency (first token measured "
                    "from enqueue)").observe(t - prev)
                reg.counter("serve_tokens_total",
                            "Tokens generated across all requests").inc()
            self._last_token_t[ev.uid] = t
        return ev

    # ------------------------------------------------------------ accessors
    def uids(self) -> list:
        seen: dict = {}
        for ev in self.events:
            seen.setdefault(ev.uid, None)
        return list(seen)

    def events_for(self, uid: int) -> list:
        return [ev for ev in self.events if ev.uid == int(uid)]

    def lifecycle(self, uid: int) -> list:
        return [ev.kind for ev in self.events_for(uid)]

    def ttfts(self) -> list:
        """Seconds from enqueue to first token, one entry per request
        that produced a first token."""
        enq: dict = {}
        out = []
        for ev in self.events:
            if ev.kind == "enqueued":
                enq[ev.uid] = ev.t
            elif ev.kind == "first_token" and ev.uid in enq:
                out.append(ev.t - enq[ev.uid])
        return out

    def token_latencies(self) -> list:
        """Per-token latency deltas, one entry per generated token."""
        prev: dict = {}
        out = []
        for ev in self.events:
            if ev.kind == "enqueued":
                prev[ev.uid] = ev.t
            elif ev.kind in ("first_token", "decode"):
                out.append(ev.t - prev.get(ev.uid, ev.t))
                prev[ev.uid] = ev.t
        return out

    def queue_waits(self) -> list:
        """Queue-entry (enqueued / preempted) to admission deltas, one
        entry per admission."""
        entered: dict = {}
        out = []
        for ev in self.events:
            if ev.kind in ("enqueued", "preempted"):
                entered[ev.uid] = ev.t
            elif ev.kind == "admitted":
                out.append(ev.t - entered.pop(ev.uid, ev.t))
        return out

    def pages_held_hwm(self) -> int:
        """High-water mark of total pages held across live requests,
        sampled at trace transitions."""
        held: dict = {}
        hwm = 0
        for ev in self.events:
            if ev.pages_held is not None:
                held[ev.uid] = ev.pages_held
                hwm = max(hwm, sum(held.values()))
        return hwm

    def preemption_count(self) -> int:
        return sum(1 for ev in self.events if ev.kind == "preempted")

    # ------------------------------------------------------------ validity
    @staticmethod
    def check_lifecycle(kinds) -> str | None:
        """Validate one request's event-kind sequence against the
        lifecycle grammar; returns None if valid, else an error string.

        Grammar (one or more *episodes*; every episode but the last
        ends in ``cancelled``/``timeout`` -- the fleet's retry path
        re-enqueues the uid -- or in ``crashed``/``quarantined`` -- the
        failover path, optionally marked by ``recovered`` before the
        re-enqueue -- and the final one ends in any terminal)::

            TRACE    := EPISODE (recovered? EPISODE)*
            EPISODE  := enqueued RESIDENCY* TERMINAL
            RESIDENCY:= admitted prefilled TOKEN decode* [preempted]
            TERMINAL := finished | cancelled | timeout
                      | crashed | quarantined

        where TOKEN is ``first_token`` on an episode's first residency
        and ``decode`` on re-admissions (the resume token is sampled
        from the re-prefill logits, which is a decode step for the
        request); ``finished`` must follow a residency (a request can
        only complete while resident), while the other terminals may
        also strike a queued or preempted request directly;
        ``finished`` must be the uid's last event overall, and
        ``recovered`` is only legal right after a ``crashed``/
        ``quarantined`` terminal -- followed by a fresh episode in a
        merged fleet trace, or ending the stream (the marker is stamped
        on the struck replica's tracer; the re-enqueue lands on the
        survivor's).
        """
        kinds = list(kinds)
        if not kinds:
            return "empty trace"
        if any(k in SWEEP_KINDS for k in kinds):
            return RequestTracer._check_sweep_lifecycle(kinds)
        i, n = 0, len(kinds)
        prev_terminal = None
        while i < n:
            if kinds[i] == "recovered":
                if prev_terminal not in FAULT_TERMINAL_KINDS:
                    return f"event {i}: 'recovered' without a " \
                           f"preceding crashed/quarantined terminal"
                i += 1
                if i >= n:
                    # valid end: the marker lives on the struck
                    # replica's tracer, the re-enqueue on the
                    # survivor's -- a single replica's stream may
                    # legally end here
                    return None
            if kinds[i] != "enqueued":
                return f"event {i}: expected 'enqueued', got {kinds[i]!r}"
            i += 1
            first_residency = True
            resident = False          # inside a residency, post-TOKEN
            terminal = None
            while terminal is None:
                if i >= n:
                    return "trace ends without a terminal event " \
                           "(finished/cancelled/timeout/crashed/" \
                           "quarantined)"
                k = kinds[i]
                if k in ("cancelled", "timeout", "crashed",
                         "quarantined"):
                    terminal = k
                    i += 1
                elif k == "finished":
                    if not resident:
                        return f"event {i}: 'finished' without a " \
                               f"residency"
                    terminal = k
                    i += 1
                elif k == "preempted":
                    if not resident:
                        return f"event {i}: 'preempted' while not " \
                               f"resident"
                    resident = False
                    i += 1
                elif k == "admitted":
                    if resident:
                        return f"event {i}: 'admitted' while already " \
                               f"resident"
                    i += 1
                    if i >= n or kinds[i] != "prefilled":
                        return f"event {i}: expected 'prefilled' " \
                               f"after 'admitted'"
                    i += 1
                    want = "first_token" if first_residency else "decode"
                    if i >= n or kinds[i] != want:
                        got = kinds[i] if i < n else "<end>"
                        return f"event {i}: expected {want!r} after " \
                               f"prefill, got {got!r}"
                    i += 1
                    first_residency = False
                    resident = True
                    while i < n and kinds[i] == "decode":
                        i += 1
                else:
                    return f"event {i}: unexpected {k!r}"
            if terminal == "finished" and i != n:
                return f"events after 'finished' at {i - 1}"
            # cancelled/timeout/crashed/quarantined: any further events
            # must be a fresh episode (the outer loop re-expects
            # 'enqueued', optionally preceded by 'recovered' after a
            # fault terminal)
            prev_terminal = terminal
        return None

    @staticmethod
    def _check_sweep_lifecycle(kinds) -> str | None:
        """Sweep-point grammar (one point per uid)::

            POINT := point_enqueued
                     (point_loaded | point_started point_finished?)?

        A bare ``point_enqueued`` (optionally followed by a bare
        ``point_started``) is a point still pending/in flight when the
        trace was written -- e.g. a sweep stopped by its ``max_points``
        execution budget; ``point_loaded`` (a store hit) and
        ``point_finished`` are terminal.
        """
        bad = [k for k in kinds if k not in SWEEP_KINDS]
        if bad:
            return f"sweep point mixes serve events: {bad[0]!r}"
        if kinds[0] != "point_enqueued":
            return f"event 0: expected 'point_enqueued', got {kinds[0]!r}"
        rest = kinds[1:]
        if rest in ([], ["point_loaded"], ["point_started"],
                    ["point_started", "point_finished"]):
            return None
        return f"invalid sweep-point sequence {kinds!r}"
