"""repro_torch.fleet: multi-replica serving over the plan Pareto front.

A :class:`Fleet` binds N :class:`~repro_torch.serve.engine.InferenceServer`
replicas to plan tiers (float / 8-bit / mixed / 2-bit points from one
compression search), routes requests across them with pluggable
policies (``round_robin`` / ``least_loaded`` / ``pareto_degrade`` /
``static:<tier>``), enforces per-request deadlines by cancelling
overdue work (pages freed, ``timeout`` lifecycle event, bounded
retries), and reports SLO attainment through the ``repro_torch.obs``
exporters.  See ``fleet.py`` for the virtual-time model.

Robustness: a :class:`~repro_torch.fleet.health.HealthMonitor` infers each
replica's state (healthy/degraded/down/draining/warming) from
heartbeats, a decode-progress watchdog and warm-up probes; routers
filter on it, and crashed/quarantined replicas' in-flight requests are
recovered recompute-style onto survivors with their token streams
byte-identical to the fault-free run (see ``repro_torch.chaos`` for the
deterministic fault injection that exercises all of this).
"""
from repro_torch.fleet.fleet import (Attempt, Fleet, FleetRequest, Replica,
                               RequestRecord, TierSpec, plan_mean_bits,
                               tier_from_plan)
from repro_torch.fleet.health import (HEALTH_STATES, ROUTABLE_STATES,
                                HealthMonitor, ReplicaHealth)
from repro_torch.fleet.loadgen import burst_trace, poisson_trace, slo_report
from repro_torch.fleet.router import (ROUTERS, LeastLoaded, ParetoDegrade,
                                RoundRobin, Router, StaticTier,
                                make_router)

__all__ = [
    "Fleet", "FleetRequest", "Replica", "RequestRecord", "Attempt",
    "TierSpec", "plan_mean_bits", "tier_from_plan",
    "HealthMonitor", "ReplicaHealth", "HEALTH_STATES",
    "ROUTABLE_STATES",
    "poisson_trace", "burst_trace", "slo_report",
    "Router", "RoundRobin", "LeastLoaded", "ParetoDegrade",
    "StaticTier", "ROUTERS", "make_router",
]
