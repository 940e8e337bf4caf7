"""Pareto-front maintenance for accuracy-vs-cost sweeps
(``repro.sweep.front``; the same arithmetic and tie-breaking, so an
adaptive lambda comes out identical in both packages).

Points are arbitrary objects read through ``score``/``cost`` accessor
callables (dicts with ``"score"``/``"cost"`` keys by default).  Score is
maximized, cost minimized.  Besides dominance filtering this module holds
the two sweep-side decision rules:

* :func:`next_lambda` -- adaptive bisection: insert the next
  regularization strength into the largest normalized accuracy-vs-cost gap
  between adjacent front points (geometric mean of the bounding lambdas,
  matching the log-scale at which lambda acts);
* :func:`iso_accuracy_report` -- the paper's headline framing: the size
  reduction the front achieves at no accuracy loss relative to fixed
  uniform-precision baselines (abstract: 47.50% over 8-bit, 69.54% over
  2-bit).
"""
from __future__ import annotations

import math

import numpy as np


def _score(p):
    return p["score"]


def _cost(p):
    return p["cost"]


def _lam(p):
    return p["lam"]


def dominates(a, b, *, score=_score, cost=_cost) -> bool:
    """True if ``a`` is at least as good as ``b`` on both axes and
    strictly better on one."""
    sa, sb = score(a), score(b)
    ca, cb = cost(a), cost(b)
    return sa >= sb and ca <= cb and (sa > sb or ca < cb)


def pareto_front(points, *, score=_score, cost=_cost) -> list:
    """Non-dominated subset, sorted by cost ascending.

    Duplicate (score, cost) pairs keep only the first point in input
    order, so the front is deterministic for deterministic sweeps.
    """
    order = sorted(range(len(points)),
                   key=lambda i: (cost(points[i]), -score(points[i]), i))
    front, best_score, seen = [], -math.inf, set()
    for i in order:
        p = points[i]
        key = (float(cost(p)), float(score(p)))
        if score(p) > best_score and key not in seen:
            front.append(p)
            best_score = score(p)
            seen.add(key)
    return front


def largest_gap(front, *, score=_score, cost=_cost):
    """(index, gap) of the widest normalized Euclidean gap between
    adjacent points of a cost-sorted front; ``(None, 0.0)`` for fronts
    with fewer than two points."""
    if len(front) < 2:
        return None, 0.0
    scores = np.asarray([float(score(p)) for p in front])
    costs = np.asarray([float(cost(p)) for p in front])
    s_range = max(float(scores.max() - scores.min()), 1e-12)
    c_range = max(float(costs.max() - costs.min()), 1e-12)
    best_i, best_gap = None, 0.0
    for i in range(len(front) - 1):
        ds = (scores[i + 1] - scores[i]) / s_range
        dc = (costs[i + 1] - costs[i]) / c_range
        gap = math.hypot(ds, dc)
        if gap > best_gap:
            best_i, best_gap = i, gap
    return best_i, best_gap


def next_lambda(front, *, lam=_lam, score=_score, cost=_cost,
                rel_tol: float = 1e-6):
    """Lambda to try next: the geometric mean of the lambdas bounding the
    front's largest accuracy-vs-cost gap (lambda acts on a log scale).

    Returns None when the front has fewer than two points or the
    bisected lambda collapses onto an existing one (within ``rel_tol``
    relative distance) -- the sweep's convergence signal.
    """
    i, _ = largest_gap(front, score=score, cost=cost)
    if i is None:
        return None
    la, lb = float(lam(front[i])), float(lam(front[i + 1]))
    if la <= 0.0 or lb <= 0.0:
        new = 0.5 * (la + lb)
    else:
        new = math.sqrt(la * lb)
    for p in front:
        ref = max(abs(float(lam(p))), 1e-12)
        if abs(new - float(lam(p))) <= rel_tol * ref:
            return None
    return new


# ---------------------------------------------------------------------------
# paper-style iso-accuracy reporting
# ---------------------------------------------------------------------------

def iso_accuracy_reduction(front, baseline_score, baseline_cost, *,
                           score=_score, cost=_cost):
    """Largest relative cost reduction any front point achieves while
    matching or beating ``baseline_score`` (paper Sec. 5 framing, e.g.
    '47.50% size reduction over the 8-bit model at iso-accuracy').

    Returns a fraction in [0, 1] (negative if even the qualifying points
    cost more), or None when no front point reaches the baseline score.
    """
    if baseline_cost <= 0:
        raise ValueError(f"baseline_cost must be positive, "
                         f"got {baseline_cost}")
    qualifying = [cost(p) for p in front if score(p) >= baseline_score]
    if not qualifying:
        return None
    return 1.0 - min(qualifying) / float(baseline_cost)


def iso_accuracy_report(front, baselines: dict, *, score=_score,
                        cost=_cost) -> dict:
    """Per-baseline iso-accuracy summary.

    ``baselines`` maps a label (e.g. ``"w8"``) to ``(score, cost)`` of a
    fixed uniform-precision reference.  Each row reports the baseline
    point, the best qualifying front cost, and the reduction fraction.
    """
    report = {}
    for label, (b_score, b_cost) in baselines.items():
        red = iso_accuracy_reduction(front, b_score, b_cost,
                                     score=score, cost=cost)
        report[label] = {
            "baseline_score": float(b_score),
            "baseline_cost": float(b_cost),
            "reduction": None if red is None else float(red),
            "reduction_pct": None if red is None else
            round(100.0 * red, 2),
        }
    return report


# ---------------------------------------------------------------------------
# discrete plan costs (the store's per-cost-model numbers)
# ---------------------------------------------------------------------------

def plan_cost(geoms, plan, model) -> float:
    """Discrete deployment cost of a CNN-track plan under a registered
    cost model, with C_in shrunk by the producer group's pruning (the
    same accounting ``discretize.assignment_size_bytes`` uses)."""
    from repro_torch.api import cost_models
    cm = cost_models.get_cost_model(model)
    kept = {grp: int(np.sum(np.asarray(b) > 0))
            for grp, b in plan.channel_bits.items()}
    total = 0.0
    for gm in geoms:
        bits = np.asarray(plan.channel_bits[gm.gamma])
        cin_eff = kept.get(gm.in_gamma, gm.cin) if gm.in_gamma else gm.cin
        total += float(cm.discrete(gm, bits, cin_eff))
    return total


def uniform_cost(geoms, bits: int, model="size") -> float:
    """Discrete cost of a uniform fixed-precision assignment (no pruning)
    -- the denominator of the paper's iso-accuracy reductions."""
    from repro_torch.api import cost_models
    cm = cost_models.get_cost_model(model)
    total = 0.0
    for gm in geoms:
        full = np.full((gm.cout,), int(bits), np.int64)
        total += float(cm.discrete(gm, full, gm.cin))
    return total
