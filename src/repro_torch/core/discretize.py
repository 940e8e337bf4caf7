"""Post-search discretization, channel reordering and NE16 refinement
(``repro.core.discretize``), on the host in numpy.

Implements paper Eq. 7/8 (argmax assignment), Fig. 3 (offline reordering
of weight channels into per-precision groups so each layer splits into
|P_W| dense sub-layers), and the Sec. 4.3.3 post-search refinement
(greedily bump channel groups *up* in precision when that reduces the
predicted NE16 cycles; it never decreases a bit-width).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import costs


def _host(v) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def assign(mps_params, pw: tuple[int, ...], px: tuple[int, ...]):
    """argmax-discretize all selection parameters (paper Eq. 7/8).

    Returns {"gamma": {group: int array (C,)}, "delta": {name: int},
             "alpha": {name: float}}.
    """
    pw_arr = np.asarray(pw)
    px_arr = np.asarray(px)
    out_g = {k: pw_arr[np.argmax(_host(v), axis=-1)]
             for k, v in mps_params["gamma"].items()}
    out_d = {k: int(px_arr[int(np.argmax(_host(v)))])
             for k, v in mps_params["delta"].items()}
    out_a = {k: float(_host(v)) for k, v in mps_params["alpha"].items()}
    return {"gamma": out_g, "delta": out_d, "alpha": out_a}


def assignment_size_bytes(geoms, assignment) -> float:
    """Exact size (bytes) of the discretized model, with pruned channels
    removed and C_in shrunk by the producer's pruning (Eq. 9, discrete)."""
    total = 0.0
    kept = {g: int(np.sum(bits > 0))
            for g, bits in assignment["gamma"].items()}
    for geom in geoms:
        bits = assignment["gamma"][geom.gamma]
        cin_eff = (kept[geom.in_gamma] if geom.in_gamma in kept
                   else geom.cin) if geom.in_gamma else geom.cin
        cin_term = 1 if geom.kind == "dwconv" else cin_eff
        total += cin_term * geom.kx * geom.ky * float(np.sum(bits)) / 8.0
    return total


def prune_fraction(assignment) -> float:
    all_bits = np.concatenate([np.asarray(v).ravel()
                               for v in assignment["gamma"].values()])
    return float(np.mean(all_bits == 0))


def bits_histogram(assignment, pw: tuple[int, ...]):
    """Per-group share of channels at each precision (paper Fig. 7/8)."""
    hist = {}
    for grp, bits in assignment["gamma"].items():
        bits = np.asarray(bits)
        hist[grp] = {b: float(np.mean(bits == b)) for b in pw}
    return hist


def reorder_permutations(assignment):
    """Stable per-group permutation sorting channels by assigned bit-width
    (pruned channels last, so dropping them is a slice)."""
    perms = {}
    for grp, bits in assignment["gamma"].items():
        bits = np.asarray(bits)
        order_key = np.where(bits == 0, 999, bits)   # pruned -> end
        perms[grp] = np.argsort(order_key, kind="stable")
    return perms


def sublayer_split(assignment, pw: tuple[int, ...]):
    """After reordering, each layer splits into contiguous per-precision
    sub-layers.  Returns {group: [(bits, start, stop), ...]} (pruned
    channels excluded)."""
    perms = reorder_permutations(assignment)
    split = {}
    for grp, bits in assignment["gamma"].items():
        sorted_bits = np.asarray(bits)[perms[grp]]
        segs, start = [], 0
        for b in sorted(set(int(x) for x in sorted_bits if x > 0)):
            n = int(np.sum(sorted_bits == b))
            segs.append((b, start, start + n))
            start += n
        split[grp] = segs
    return split


def ne16_refine(geoms, assignment, group_size: int = 32):
    """Greedy, monotone-increase precision refinement.

    For every layer and every precision group whose channel count is not
    a multiple of ``group_size``, try promoting the spill (count %
    group_size channels) to the next higher precision; keep the change if
    the discrete NE16 cycle count decreases.  Never decreases precision.
    """
    new_gamma = {k: np.asarray(v).copy()
                 for k, v in assignment["gamma"].items()}
    kept = {g: int(np.sum(b > 0)) for g, b in new_gamma.items()}

    def layer_cycles(geom, bits):
        cin_eff = (kept.get(geom.in_gamma, geom.cin)
                   if geom.in_gamma else geom.cin)
        return costs.ne16_cycles_discrete(geom, bits, cin_eff)

    changed = 0
    for geom in geoms:
        bits = new_gamma[geom.gamma]
        levels = sorted(set(int(b) for b in bits if b > 0))
        for li, b in enumerate(levels):
            spill = int(np.sum(bits == b)) % group_size
            if spill == 0 or b == 8:
                continue
            higher = ([lv for lv in levels[li + 1:]] + [8])[0]
            cand = bits.copy()
            idx = np.where(cand == b)[0][-spill:]
            cand[idx] = higher
            if layer_cycles(geom, cand) < layer_cycles(geom, bits):
                new_gamma[geom.gamma] = cand
                bits = cand
                changed += spill
    out = dict(assignment)
    out["gamma"] = new_gamma
    return out, changed
