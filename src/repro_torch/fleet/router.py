"""Routing policies: which replica serves the next request.

Routers are stateless-ish strategy objects over a :class:`Fleet`; each
``route(fr, now)`` call returns ``(replica, degraded)`` -- or
``(None, _)`` to shed the request.  ``degraded`` flags a dispatch below
the fleet's top-quality tier, which the SLO report surfaces so quality
give-ups are visible, not silent.

- ``round_robin`` -- cyclic, load-blind; the parity baseline.
- ``least_loaded`` -- fewest in-flight requests, then fewest pages in
  use (both from the replica's host-side ``load_report()``).
- ``pareto_degrade`` -- walk tiers from highest quality down, pick the
  first whose fluid-model ETA (:meth:`Fleet.predicted_completion_ms`)
  meets the request's deadline; shed when even the cheapest misses it.
  Deadline-less requests always take the top tier: at low load the
  fleet serves full quality, under pressure it slides down the Pareto
  front, and it recovers as predicted waits shrink.
- ``static:<tier>`` -- pin one tier; the single-tier baseline the bench
  compares ``pareto_degrade`` against.

Every policy routes over the fleet's health-filtered candidate set
(:meth:`Router.candidates`): ``down``/``warming`` replicas are never
eligible, ``draining`` ones only when nothing healthier exists (a
saturated pool is survivable, a dead session is not).  With every
replica healthy the candidate set is the whole fleet and routing is
exactly the pre-failover behavior.
"""
from __future__ import annotations


class Router:
    """Base policy: subclasses implement :meth:`route`."""

    name = "base"

    def __init__(self, fleet):
        self.fleet = fleet

    def candidates(self):
        """Replicas ordinary traffic may target: the health monitor's
        routable set (healthy/degraded), falling back to draining
        replicas when no routable one exists.  Empty means every
        dispatch sheds until something recovers."""
        health = self.fleet.health
        out = [r for r in self.fleet.replicas
               if health.routable(r.tier.name)]
        if not out:
            out = [r for r in self.fleet.replicas
                   if health.state(r.tier.name) == "draining"]
        return out

    def route(self, fr, now):
        """-> (Replica | None, degraded: bool); None sheds."""
        raise NotImplementedError


class RoundRobin(Router):
    name = "round_robin"

    def __init__(self, fleet):
        super().__init__(fleet)
        self._i = 0

    def route(self, fr, now):
        reps = self.candidates()
        if not reps:
            return None, False
        rep = reps[self._i % len(reps)]
        self._i += 1
        return rep, False


class LeastLoaded(Router):
    name = "least_loaded"

    def route(self, fr, now):
        reps = self.candidates()
        if not reps:
            return None, False

        def key(pair):
            idx, rep = pair
            load = rep.server.load_report()
            return (load["queued"] + load["active"],
                    load["pages_in_use"], idx)
        _, rep = min(enumerate(reps), key=key)
        return rep, False


class ParetoDegrade(Router):
    name = "pareto_degrade"

    def route(self, fr, now):
        by_quality = lambda r: (-r.tier.quality, r.tier.name)  # noqa: E731
        reps = sorted(self.candidates(), key=by_quality)
        if not reps:
            return None, True
        # "degraded" is judged against the fleet's overall top tier:
        # routing around a down top replica is a quality give-up too
        top = min(self.fleet.replicas, key=by_quality)
        if fr.deadline_ms is None:
            return reps[0], reps[0] is not top
        deadline_abs = now + fr.deadline_ms
        for rep in reps:
            eta = self.fleet.predicted_completion_ms(rep, fr, now)
            if eta <= deadline_abs + 1e-9:
                return rep, rep is not top
        return None, True          # hopeless everywhere: shed

    # the recovery property is free: predicted waits are a pure
    # function of current backlog, so when load drains the top tier
    # becomes feasible again and deadline-carrying requests move back up


class StaticTier(Router):
    """Pin every request to one named tier (``static:<name>``).
    Requests still queue on a draining pinned tier (old single-replica
    behavior), but shed while it is down or warming."""

    name = "static"

    def __init__(self, fleet, tier: str):
        super().__init__(fleet)
        self.rep = fleet.replica_by_name(tier)

    def route(self, fr, now):
        state = self.fleet.health.state(self.rep.tier.name)
        if state in ("down", "warming"):
            return None, False
        return self.rep, False


ROUTERS = {r.name: r for r in (RoundRobin, LeastLoaded, ParetoDegrade)}


def make_router(spec: str, fleet) -> Router:
    """``spec``: a name from :data:`ROUTERS` or ``static:<tier>``."""
    if spec.startswith("static:"):
        return StaticTier(fleet, spec.split(":", 1)[1])
    try:
        return ROUTERS[spec](fleet)
    except KeyError:
        raise ValueError(
            f"unknown routing policy {spec!r}; have "
            f"{sorted(ROUTERS)} or 'static:<tier>'") from None
