"""Fault injection driven by the fleet's virtual clock
(``repro.chaos.inject``).

:class:`ChaosInjector` turns a fault schedule into a stream of
``(phase, FaultSpec)`` events the fleet consumes inside its event loop:
``inject`` at ``t_ms`` and ``restore`` at ``until_ms``.  The injector
never touches a replica itself -- the fleet applies each event at the
matching host boundary (engine session API, cache backend, router
candidate set), so no fault reaches inside a kernel.

The two injection helpers that ARE host-boundary mutations live here:
:func:`poison_params` (the ``nan_plan`` fault -- swaps NaN parameters
into a server's bound tree, returning an undo closure) and
:func:`corrupt_store_entry` (the ``store_corrupt`` fault -- writes
garbage over a :class:`~repro_torch.sweep.store.PlanStore` entry file).

The poison never writes in place.  Every replica of a fleet is built
from one parameter tree, so a float server's leaves (and the tensors a
plan-bound server's unplanned leaves share) are the same tensors in
every replica: an in-place fill would poison every tier at once.
:func:`poison_params` instead builds new NaN tensors on the leaf's
device -- for a plan-bound projection, a new
:class:`~repro_torch.nn.quantized.PackedLinear` whose packed weights are
the old module's and whose scales are new NaN tensors -- and swaps a new
tree into ``server.params``; ``undo()`` puts the old tree object back.
"""
from __future__ import annotations

import os

import torch

from repro_torch.nn.quantized import PackedLinear


class ChaosInjector:
    """Replays a fault schedule against a virtual clock.

    ``due(now)`` returns every not-yet-delivered ``(phase, spec)``
    event with ``t <= now`` (each exactly once, in schedule order);
    ``next_time()`` is the earliest undelivered event time, which the
    fleet folds into its next-event computation so the clock jumps TO
    fault times instead of over them.
    """

    def __init__(self, schedule):
        self.schedule = list(schedule)
        events = []
        for i, f in enumerate(self.schedule):
            events.append((float(f.t_ms), i, "inject", f))
            if f.until_ms is not None:
                events.append((float(f.until_ms), i, "restore", f))
        self._events = sorted(events, key=lambda e: (e[0], e[1],
                                                     e[2] != "inject"))
        self.delivered: list = []     # (t, phase, spec) in delivery order

    def due(self, now: float, eps: float = 1e-9) -> list:
        out = []
        while self._events and self._events[0][0] <= now + eps:
            t, _, phase, spec = self._events.pop(0)
            self.delivered.append((t, phase, spec))
            out.append((phase, spec))
        return out

    def next_time(self):
        return self._events[0][0] if self._events else None

    @property
    def exhausted(self) -> bool:
        return not self._events


# ---------------------------------------------------------------------------
# host-boundary mutations
# ---------------------------------------------------------------------------

def _nan_like(leaf: torch.Tensor) -> torch.Tensor:
    """A new tensor of ``leaf``'s shape, dtype and device, all NaN."""
    return torch.full_like(leaf, float("nan"))


def _poison_node(node):
    """Depth-first: NaN the first packed-linear scale set (quantized
    tier) or the first float matrix leaf (float tier).  Returns
    ``(new_node, hit)``; ``node`` itself is never modified."""
    if isinstance(node, PackedLinear):
        if not node.bits:
            return node, False            # fully pruned: keep looking
        groups = tuple((b, wq, _nan_like(sw)) for b, wq, sw in node.groups)
        return PackedLinear(groups, node.out_index, node.n_in,
                            node.n_out), True
    if isinstance(node, dict):
        out = {}
        hit = False
        for k in node:
            if hit:
                out[k] = node[k]
            else:
                out[k], hit = _poison_node(node[k])
        return out, hit
    if isinstance(node, (tuple, list)):
        out = []
        hit = False
        for v in node:
            if hit:
                out.append(v)
            else:
                nv, hit = _poison_node(v)
                out.append(nv)
        return type(node)(out) if isinstance(node, tuple) else out, hit
    if isinstance(node, torch.Tensor) and node.is_floating_point() \
            and node.ndim >= 2:
        return _nan_like(node), True
    return node, False


def poison_params(server):
    """NaN-poison one projection of a server's bound parameter tree --
    the ``nan_plan`` fault.  The poisoned tree is swapped in between
    steps (same shapes, dtypes and device; the kernels run unchanged)
    and the engine's sampling-boundary NaN guard trips on the next
    step.  Returns an ``undo()`` closure that puts the original tree
    object back."""
    old = server.params
    blocks, hit = _poison_node(old["blocks"])
    if not hit:
        raise RuntimeError("poison_params found no poisonable leaf in "
                           "params['blocks']")
    new = dict(old)
    new["blocks"] = blocks
    server.params = new

    def undo():
        server.params = old
    return undo


def corrupt_store_entry(store, name: str) -> str:
    """Overwrite a PlanStore entry file with garbage bytes -- the
    ``store_corrupt`` fault.  Returns the path written.  The store's
    read path surfaces it as
    :class:`~repro_torch.sweep.store.StoreCorruptError`, which the sweep's
    resume path quarantines and recomputes."""
    path = store._entry_path(name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no entry {name!r} to corrupt "
                                f"({path})")
    with open(path, "w") as f:
        f.write("{\"entry_version\": 1, \"name\": \"")   # truncated JSON
    return path
