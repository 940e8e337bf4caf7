"""Replica health: heartbeat + progress watchdog + warm-up probes.

The :class:`HealthMonitor` infers each replica's state from the same
host-side signals a real deployment would export -- it never reads
fault schedules.  Signals per observation (one per fleet event-loop
iteration):

- **heartbeat**: ``Replica.heartbeat()`` returns the engine's
  ``load_report()`` or ``None`` when the session is dead.  A dead
  heartbeat means ``down``; a returning one on a down replica means
  ``warming`` (the fleet then issues a warm-up probe, and only a
  finished probe re-admits the replica to routing).
- **progress watchdog**: ``load_report()["steps"]`` is the engine's
  decode-step counter.  The monitor timestamps counter advances on the
  virtual clock; when consecutive steps are spaced wider than
  ``watchdog_factor`` times the tier's modeled ``step_ms``, the replica
  is ``degraded`` (and the observed spacing ratio is published as its
  ETA multiplier for the routers' completion model).  Spacing back
  under the threshold heals it.
- **admission pressure**: a paged replica with zero free pages and a
  non-empty queue is ``draining`` -- it keeps decoding residents but
  takes no new routes until pages free up.

States: ``healthy -> degraded -> down -> draining -> warming`` (see
:data:`HEALTH_STATES`).  ``routable()`` is ``healthy``/``degraded``;
``warming`` accepts only its probe; ``down``/``draining`` accept
nothing.  Transitions feed the ``health_*`` metric family:
``health_state{replica}`` (the state's index in ``HEALTH_STATES``) and
``health_transitions_total{replica,state}``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

HEALTH_STATES = ("healthy", "degraded", "down", "draining", "warming")
# states a router may send ordinary traffic to
ROUTABLE_STATES = ("healthy", "degraded")


@dataclasses.dataclass
class ReplicaHealth:
    """Mutable health record for one replica."""

    state: str = "healthy"
    since_ms: float = 0.0
    cause: str = ""
    last_steps: int = 0               # last observed decode-step count
    last_step_ms: Optional[float] = None   # virtual time of last advance
    eta_multiplier: float = 1.0       # observed step spacing / modeled


class HealthMonitor:
    """Per-replica health state machine over host-side signals."""

    def __init__(self, *, watchdog_factor: float = 3.0, registry=None):
        if watchdog_factor <= 1.0:
            raise ValueError(f"watchdog_factor must be > 1, "
                             f"got {watchdog_factor}")
        self.watchdog_factor = float(watchdog_factor)
        self.registry = registry if (registry is not None
                                     and registry.enabled) else None
        self._health: dict[str, ReplicaHealth] = {}

    def start(self, names, now: float = 0.0):
        """Reset every replica to ``healthy`` at ``now`` (one fleet
        run = one health epoch)."""
        self._health = {n: ReplicaHealth(since_ms=now) for n in names}
        for n in names:
            self._gauge(n)

    # ------------------------------------------------------------- queries
    def health(self, name: str) -> ReplicaHealth:
        h = self._health.get(name)
        if h is None:
            h = self._health[name] = ReplicaHealth()
        return h

    def state(self, name: str) -> str:
        return self.health(name).state

    def routable(self, name: str) -> bool:
        return self.health(name).state in ROUTABLE_STATES

    def eta_multiplier(self, name: str) -> float:
        """Observed decode-step slowdown (>= 1.0) for the routers'
        completion-time model; 1.0 unless the watchdog measured
        wider-than-modeled step spacing."""
        return max(1.0, self.health(name).eta_multiplier)

    def states(self) -> dict:
        return {n: h.state for n, h in self._health.items()}

    # --------------------------------------------------------- transitions
    def mark(self, name: str, state: str, now: float, cause: str = ""):
        if state not in HEALTH_STATES:
            raise ValueError(f"unknown health state {state!r}")
        h = self.health(name)
        if h.state == state:
            return
        h.state = state
        h.since_ms = now
        h.cause = cause
        if state in ("down", "warming"):
            # forget stale progress so the watchdog restarts cleanly
            # against the reopened session's zeroed step counter
            h.last_step_ms = None
            h.last_steps = 0
            h.eta_multiplier = 1.0
        if self.registry is not None:
            self.registry.counter(
                "health_transitions_total",
                "Replica health-state transitions",
                labels=("replica", "state")).inc(replica=name,
                                                 state=state)
        self._gauge(name)

    def _gauge(self, name: str):
        if self.registry is not None:
            h = self.health(name)
            self.registry.gauge(
                "health_state",
                "Replica health state (index into "
                "healthy/degraded/down/draining/warming)",
                labels=("replica",)).set(
                HEALTH_STATES.index(h.state), replica=name)

    # --------------------------------------------------------- observation
    def observe(self, rep, now: float):
        """One observation of ``rep`` (a :class:`repro_torch.fleet.fleet.
        Replica`) at virtual time ``now``."""
        name = rep.tier.name
        h = self.health(name)
        load = rep.heartbeat()
        if load is None:
            if h.state != "down":
                self.mark(name, "down", now, cause=rep.down_cause)
            return
        if h.state == "down":
            # the session answers again: warm up, don't route yet --
            # the fleet issues a probe and probe_done() re-admits
            self.mark(name, "warming", now, cause="heartbeat")
            return
        if h.state == "warming":
            return                      # gated on the warm-up probe
        # progress watchdog over the decode-step counter.  Spacing only
        # means "stalled" while the replica continuously has work: an
        # idle gap between bursts resets the watchdog instead of
        # reading as a 100x slowdown.
        steps = int(load.get("steps", 0))
        if steps < h.last_steps:          # session was reopened
            h.last_steps = steps
            h.last_step_ms = None
        if load.get("active", 0) == 0 and load.get("queued", 0) == 0:
            h.last_step_ms = None
            h.eta_multiplier = 1.0
        elif steps > h.last_steps:
            if h.last_step_ms is not None:
                spacing = now - h.last_step_ms
                modeled = max(rep.tier.step_ms, 1e-9)
                h.eta_multiplier = max(1.0, spacing / modeled)
            h.last_steps = steps
            h.last_step_ms = now
        slow = h.eta_multiplier > self.watchdog_factor
        # admission pressure: no free pages + queued work = draining
        report = load if "pages_free" in load else None
        starved = (report is not None and report["pages_free"] == 0
                   and load.get("queued", 0) > 0)
        if starved:
            if h.state != "draining":
                self.mark(name, "draining", now, cause="pool")
        elif slow:
            if h.state != "degraded":
                self.mark(name, "degraded", now, cause="watchdog")
        elif h.state in ("degraded", "draining"):
            self.mark(name, "healthy", now, cause="recovered")

    def probe_done(self, name: str, ok: bool, now: float):
        """A warm-up probe finished (``ok``) or died; a passed probe
        re-admits the replica to routing."""
        if self.registry is not None:
            self.registry.counter(
                "health_probes_total",
                "Warm-up probes issued to recovering replicas, by "
                "outcome", labels=("replica", "ok")).inc(
                replica=name, ok="true" if ok else "false")
        if ok and self.state(name) == "warming":
            self.mark(name, "healthy", now, cause="probe")
