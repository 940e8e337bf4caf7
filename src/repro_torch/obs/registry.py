"""Metrics registry: Counter / Gauge / Histogram behind one namespace.

The registry is the single sink every instrumented layer writes into --
the serving engine, the cache backends, the scheduler's tracer and the
compression phases all share one :class:`MetricsRegistry`, so an export
(Prometheus text, JSON snapshot) is one call over one object.

Design constraints (the serving hot loop is the customer):

* **Cheap when disabled.**  ``MetricsRegistry(enabled=False)`` hands out
  a shared no-op metric whose ``inc``/``set``/``observe`` do nothing;
  instrumented code never branches on the registry itself.
* **Host boundaries only.**  Nothing in this module touches torch -- a
  metric update is a dict lookup plus a float add, and instrumentation
  sites live outside device code, so enabling metrics never changes a
  kernel launch or forces a device sync.
* **Fixed log-spaced latency buckets.**  :data:`LATENCY_BUCKETS_S` spans
  1 us .. 100 s at four buckets per decade; histograms default to it so
  every latency series is directly comparable.

Naming follows the Prometheus conventions: ``snake_case`` metric names,
``_total`` suffix on counters, ``_seconds`` unit suffixes, label values
always strings.  Metric names, labels and export bytes are the JAX
package's ``repro.obs`` (its ``src/repro/obs/README.md`` holds the
catalog), so one validator and one schema read both packages' files.
"""
from __future__ import annotations

import bisect

# 1e-6 s .. 1e2 s, four buckets per decade (ratio 10^0.25 ~ 1.78):
# fixed so latency histograms from different runs/layers share edges.
LATENCY_BUCKETS_S = tuple(10.0 ** (e / 4.0) for e in range(-24, 9))


class _NoopMetric:
    """Shared stand-in handed out by a disabled registry."""

    __slots__ = ()

    def inc(self, *args, **labels):
        pass

    def set(self, *args, **labels):
        pass

    def observe(self, *args, **labels):
        pass


_NOOP = _NoopMetric()


class Metric:
    """One named metric family; ``series`` maps label-value tuples (in
    ``label_names`` order) to that series' state."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels=()):
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self.series: dict = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.label_names)


class Counter(Metric):
    """Monotonically increasing total."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels):
        if value < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc by {value})")
        key = self._key(labels)
        self.series[key] = self.series.get(key, 0.0) + float(value)

    def value(self, **labels) -> float:
        return self.series.get(self._key(labels), 0.0)


class Gauge(Metric):
    """Point-in-time value (idempotent ``set``)."""

    kind = "gauge"

    def set(self, value: float, **labels):
        self.series[self._key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels):
        key = self._key(labels)
        self.series[key] = self.series.get(key, 0.0) + float(value)

    def value(self, **labels) -> float:
        return self.series.get(self._key(labels), 0.0)


class Histogram(Metric):
    """Fixed-bucket histogram (Prometheus ``le`` semantics: a bucket
    counts observations ``<=`` its upper bound)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels=(),
                 buckets=LATENCY_BUCKETS_S):
        super().__init__(name, help, labels)
        buckets = tuple(float(b) for b in buckets)
        if not buckets or any(b2 <= b1 for b1, b2 in zip(buckets,
                                                         buckets[1:])):
            raise ValueError(f"histogram {name!r} buckets must be a "
                             f"non-empty ascending sequence")
        self.buckets = buckets

    def observe(self, value: float, **labels):
        key = self._key(labels)
        h = self.series.get(key)
        if h is None:
            h = self.series[key] = {
                "counts": [0] * (len(self.buckets) + 1),   # +1: +Inf
                "sum": 0.0, "count": 0}
        h["counts"][bisect.bisect_left(self.buckets, float(value))] += 1
        h["sum"] += float(value)
        h["count"] += 1

    def count(self, **labels) -> int:
        h = self.series.get(self._key(labels))
        return 0 if h is None else h["count"]


class MetricsRegistry:
    """Get-or-create namespace of metrics plus a JSON-able snapshot.

    ``enabled=False`` makes every accessor return a shared no-op metric:
    instrumentation stays in place and costs one attribute call.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._metrics: dict[str, Metric] = {}
        # per-(phase, metric) step high-water marks backing the
        # idempotent phase-metric emission contract (see emit_phase_point)
        self._phase_hwm: dict[tuple, int] = {}

    # ------------------------------------------------------------ accessors
    def _get(self, cls, name: str, help: str, labels, **kwargs):
        if not self.enabled:
            return _NOOP
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, labels, **kwargs)
            self._metrics[name] = m
            return m
        if not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{m.kind}, requested {cls.kind}")
        if m.label_names != tuple(labels):
            raise ValueError(f"metric {name!r} registered with labels "
                             f"{m.label_names}, requested {tuple(labels)}")
        return m

    def counter(self, name: str, help: str = "", labels=()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets=LATENCY_BUCKETS_S) -> Histogram:
        h = self._get(Histogram, name, help, labels, buckets=buckets)
        if h is not _NOOP and h.buckets != tuple(float(b)
                                                 for b in buckets):
            raise ValueError(f"histogram {name!r} registered with "
                             f"different buckets")
        return h

    # ------------------------------------------------- phase-metric points
    def emit_phase_point(self, phase: str, step: int, values: dict):
        """Record one step's worth of compression-phase metrics.

        **Idempotent under checkpoint resume**: each (phase, metric) pair
        keeps a step high-water mark, and a point at a step at or below
        it is dropped.  A resumed run replays the steps between the
        restored checkpoint and the crash point to rebuild bit-exact
        state -- those replayed steps were already emitted by the crashed
        run into this same registry and must not be counted twice.  (Use
        a fresh registry for a genuinely new run of the same recipe.)
        """
        if not self.enabled:
            return
        for metric, value in values.items():
            key = (str(phase), str(metric))
            if int(step) <= self._phase_hwm.get(key, -1):
                continue
            self._phase_hwm[key] = int(step)
            self.gauge("compress_step_value",
                       "Latest value of a compression-phase step metric",
                       labels=("phase", "metric")).set(
                float(value), phase=phase, metric=metric)
            self.counter("compress_step_points_total",
                         "Phase step-metric points emitted (replayed "
                         "steps after a checkpoint resume are not "
                         "re-counted)",
                         labels=("phase", "metric")).inc(
                phase=phase, metric=metric)

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        """JSON-able state of every registered metric.

        ``{name: {kind, help, labels, series: [{labels: {..}, ...}]}}``;
        counter/gauge series carry ``value``, histogram series carry
        ``count`` / ``sum`` / ``buckets`` (cumulative ``[le, count]``
        pairs ending with ``["+Inf", count]``).
        """
        out: dict = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            series = []
            for key in sorted(m.series):
                labels = dict(zip(m.label_names, key))
                if m.kind == "histogram":
                    h = m.series[key]
                    cum, buckets = 0, []
                    for le, c in zip(m.buckets, h["counts"]):
                        cum += c
                        buckets.append([le, cum])
                    buckets.append(["+Inf", cum + h["counts"][-1]])
                    series.append({"labels": labels, "count": h["count"],
                                   "sum": h["sum"], "buckets": buckets})
                else:
                    series.append({"labels": labels,
                                   "value": m.series[key]})
            out[name] = {"kind": m.kind, "help": m.help,
                         "labels": list(m.label_names), "series": series}
        return out
