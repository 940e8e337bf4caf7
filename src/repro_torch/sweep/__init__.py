"""Pareto-front search orchestration (``repro.sweep``), in torch.

The paper's headline artifact -- an accuracy-vs-cost front of jointly
pruned + channel-wise mixed-precision networks -- as a resumable
campaign: :class:`SweepSpec` / :class:`SweepRunner` execute the points
(explicit lambda grid + adaptive bisection, warm-start continuation
between points), :class:`PlanStore` persists every finished plan with its
metrics and lineage (the JAX package's layout and content hash), and
:mod:`repro_torch.sweep.front` maintains the front and produces the
paper-style iso-accuracy reports.
"""
from repro_torch.sweep.front import (dominates, iso_accuracy_reduction,
                                     iso_accuracy_report, largest_gap,
                                     next_lambda, pareto_front, plan_cost,
                                     uniform_cost)
from repro_torch.sweep.runner import (SweepRunner, SweepSpec,
                                      available_benches, register_bench)
from repro_torch.sweep.store import (PlanStore, StoreCorruptError,
                                     StoreError, plan_hash)

__all__ = [
    "PlanStore", "StoreCorruptError", "StoreError", "SweepRunner",
    "SweepSpec",
    "available_benches", "dominates", "iso_accuracy_reduction",
    "iso_accuracy_report", "largest_gap", "next_lambda", "pareto_front",
    "plan_cost", "plan_hash", "register_bench", "uniform_cost",
]
