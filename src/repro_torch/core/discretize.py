"""Fig. 3 channel reordering (the part of ``repro.core.discretize`` that
serving needs): channels sorted into contiguous per-precision groups."""
from __future__ import annotations

import numpy as np


def prune_fraction(assignment) -> float:
    all_bits = np.concatenate([np.asarray(v).ravel()
                               for v in assignment["gamma"].values()])
    return float(np.mean(all_bits == 0))


def reorder_permutations(assignment):
    """Stable per-group permutation sorting channels by assigned bit-width
    (pruned channels last, so dropping them is a slice)."""
    perms = {}
    for grp, bits in assignment["gamma"].items():
        bits = np.asarray(bits)
        order_key = np.where(bits == 0, 999, bits)   # pruned -> end
        perms[grp] = np.argsort(order_key, kind="stable")
    return perms
