"""repro_torch.obs: serving + search observability.

One telemetry contract across every layer: the serving engine,
scheduler, cache backends and sampling path, and the compression
phases all write into a shared :class:`MetricsRegistry`; the serving
engine additionally records per-request lifecycle events through a
:class:`RequestTracer`.  :class:`Observability` bundles the two.

Everything is host-side and dependency-free; with the registry
disabled each instrumentation site costs a no-op method call, and no
site lives inside device code.  The metric catalog and the exporter
formats are the JAX package's (``src/repro/obs/README.md``): the same
names, labels and event grammar, so either package's
``obs.validate`` accepts the other's artifacts.
"""
from .registry import (LATENCY_BUCKETS_S, Counter, Gauge, Histogram,
                       MetricsRegistry)
from .tracing import (EVENT_KINDS, FAULT_TERMINAL_KINDS, SWEEP_KINDS,
                      TERMINAL_KINDS, RequestTracer, TraceEvent)
from .exporters import (percentiles, run_summary, to_prometheus,
                        trace_to_jsonl, write_prometheus, write_trace)


class Observability:
    """Bundle of a metrics registry and a request tracer.

    ``Observability()`` enables both; ``metrics=False`` leaves a
    disabled registry (no-op metrics), ``trace=False`` drops the tracer
    (``obs.tracer is None``).  Pass an instance to
    ``InferenceServer(..., obs=...)`` or ``server.attach_obs(obs)``.
    """

    def __init__(self, metrics: bool = True, trace: bool = True,
                 registry=None, replica=None):
        # pass registry= to share one metric namespace across several
        # servers (the fleet does this: one registry, one tracer per
        # replica tagged via replica=)
        self.registry = (registry if registry is not None
                         else MetricsRegistry(enabled=metrics))
        self.tracer = (RequestTracer(self.registry, replica=replica)
                       if trace else None)

    def summary(self) -> dict:
        """End-of-run summary (empty when tracing is off)."""
        if self.tracer is None:
            return {}
        return run_summary(self.tracer, self.registry)


__all__ = [
    "LATENCY_BUCKETS_S", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "EVENT_KINDS", "FAULT_TERMINAL_KINDS",
    "SWEEP_KINDS", "TERMINAL_KINDS", "RequestTracer", "TraceEvent",
    "Observability", "percentiles", "run_summary", "to_prometheus",
    "trace_to_jsonl", "write_prometheus", "write_trace",
]
