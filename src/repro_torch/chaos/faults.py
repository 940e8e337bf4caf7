"""Deterministic fault declarations for the serving fleet.

A chaos run is a *schedule*: a list of :class:`FaultSpec` records, each
pinned to the fleet's virtual clock (milliseconds).  Schedules come from
:func:`parse_chaos` -- a compact CLI grammar where every field left
unspecified is drawn from a seeded generator, so ``--chaos crash+slow
--chaos-seed 7`` names one exact fault sequence forever -- or are built
directly in tests.

Fault taxonomy (see ``src/repro/chaos/README.md`` for the injection-point
contract):

``crash``
    The target replica's engine session dies at ``t_ms`` (queue, decode
    slots and cache pages are lost).  ``until_ms`` is the recovery time:
    the replica reopens a fresh session and must pass a warm-up probe
    before the router re-admits it.
``slow``
    The target replica's modeled decode-step cost is multiplied by
    ``factor`` over ``[t_ms, until_ms]`` -- a purely virtual-clock
    fault, detected by the health watchdog as degradation.
``pool_pressure``
    ``pages`` pages are withheld from the target replica's page pool
    over ``[t_ms, until_ms]`` (host-side bookkeeping in the cache
    backend), forcing preemptions / blocked admissions.
``nan_plan``
    The target replica's bound parameters are NaN-poisoned at ``t_ms``
    (a corrupted quantized plan group); the engine's sampling-boundary
    NaN guard trips on the next step and the fleet quarantines the
    replica.  ``until_ms`` restores the original parameters (the
    warm-up probe then passes).
``store_corrupt``
    The named :class:`~repro_torch.sweep.store.PlanStore` entry is overwritten
    with garbage at ``t_ms`` (``target`` is the entry name).  Exercises
    the store's quarantine-and-recompute resume path; no replica
    involvement.

Faults are injected at HOST BOUNDARIES only -- the engine session API,
the cache backend's bookkeeping, the router's candidate set, the plan
store's files -- never inside device code.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

FAULT_KINDS = ("crash", "slow", "pool_pressure", "nan_plan",
               "store_corrupt")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declared fault, pinned to the virtual clock."""

    kind: str
    target: str = ""                  # tier name (or store entry name)
    t_ms: float = 0.0                 # injection time
    until_ms: Optional[float] = None  # recovery / restore time
    factor: float = 4.0               # slow: step_ms multiplier
    pages: int = 1                    # pool_pressure: pages withheld

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {FAULT_KINDS})")
        if self.t_ms < 0:
            raise ValueError(f"t_ms must be >= 0, got {self.t_ms}")
        if self.until_ms is not None and self.until_ms <= self.t_ms:
            raise ValueError(f"until_ms ({self.until_ms}) must be > "
                             f"t_ms ({self.t_ms})")
        if self.kind == "slow" and self.factor <= 1.0:
            raise ValueError(f"slow factor must be > 1, "
                             f"got {self.factor}")
        if self.kind == "pool_pressure" and self.pages < 1:
            raise ValueError(f"pool_pressure needs pages >= 1, "
                             f"got {self.pages}")

    def describe(self) -> str:
        span = (f"@{self.t_ms:g}" if self.until_ms is None
                else f"@{self.t_ms:g}-{self.until_ms:g}")
        extra = ""
        if self.kind == "slow":
            extra = f" x{self.factor:g}"
        elif self.kind == "pool_pressure":
            extra = f" p{self.pages}"
        return f"{self.kind}{span} -> {self.target or '?'}{extra}"


def parse_chaos(spec: str, *, targets, seed: int = 0,
                horizon_ms: float = 2000.0) -> list[FaultSpec]:
    """Parse a chaos spec string into a deterministic fault schedule.

    ``spec`` is fault tokens joined by ``+`` (or commas), each::

        kind[@t0[-t1]][:modifier]...

    where modifiers are ``x<float>`` (slow factor), ``p<int>``
    (pool-pressure pages) or a bare target name.  Every field left out
    is drawn from ``np.random.default_rng(seed)`` IN TOKEN ORDER, so
    ``(spec, targets, seed, horizon_ms)`` names one exact schedule:

    - target: uniform over ``targets`` (tier names, in fleet order)
    - t0: uniform in ``[0.2, 0.5] * horizon_ms``
    - t1: ``t0 +`` uniform in ``[0.25, 0.45] * horizon_ms``

    Examples: ``crash+slow``, ``crash@300:w8``,
    ``slow@200-900:x6:float``, ``pool_pressure:p4``.
    """
    targets = list(targets)
    if not targets:
        raise ValueError("parse_chaos needs at least one target tier")
    rng = np.random.default_rng(int(seed))
    out = []
    tokens = [t.strip() for t in spec.replace(",", "+").split("+")
              if t.strip()]
    if not tokens:
        raise ValueError(f"empty chaos spec {spec!r}")
    for tok in tokens:
        fields = tok.split(":")
        head = fields[0]
        t0 = t1 = None
        if "@" in head:
            head, _, when = head.partition("@")
            a, dash, b = when.partition("-")
            t0 = float(a)
            t1 = float(b) if dash else None
        kind = head.strip()
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in chaos "
                             f"token {tok!r}")
        target = None
        factor, pages = 4.0, 1
        for f in fields[1:]:
            f = f.strip()
            if not f:
                continue
            if f[0] == "x" and _is_num(f[1:]):
                factor = float(f[1:])
            elif f[0] == "p" and f[1:].isdigit():
                pages = int(f[1:])
            else:
                target = f
        # seeded draws happen in a FIXED order per token (target, t0,
        # t1) regardless of which were given, so adding an explicit
        # field never shifts the other tokens' draws
        drawn_target = targets[int(rng.integers(len(targets)))]
        drawn_t0 = float(rng.uniform(0.2, 0.5) * horizon_ms)
        drawn_dt = float(rng.uniform(0.25, 0.45) * horizon_ms)
        if target is None:
            target = drawn_target
        elif target not in targets:
            raise ValueError(f"unknown target {target!r} in chaos "
                             f"token {tok!r} (targets: {targets})")
        if t0 is None:
            t0 = drawn_t0
        if t1 is None and kind != "store_corrupt":
            t1 = t0 + drawn_dt
        out.append(FaultSpec(kind=kind, target=target, t_ms=t0,
                             until_ms=t1, factor=factor, pages=pages))
    return out


def _is_num(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False
