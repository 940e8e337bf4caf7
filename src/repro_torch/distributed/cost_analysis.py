"""Cost analysis of one traced step (``repro.distributed.hlo_analysis``).

The reference reads the roofline terms off the compiled per-device HLO.
The port has no compiled program: it runs the step once, eagerly, on one
rank of a process group (the dry-run's ``fake`` group and ``meta``
tensors: shapes, no data), and counts what that rank dispatches:

* ``flops`` -- the formulas ``torch.utils.flop_counter.FlopCounterMode``
  reads (its ``flop_registry``): 2 * M * N * K for every product (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``; an ``einsum`` or ``matmul`` dispatches
  one of them), the reference's ``dot`` convention.  They are applied
  by :class:`OpTally` itself: ``FlopCounterMode`` hands the formula the
  ``out_dtype`` of ``bmm``'s float32-output overload (the MoE banks'
  ``matmul_f32``) as its output shape and raises;
* ``bytes`` -- operand plus result bytes of every operator that is not a
  view or an allocation (:class:`OpTally`, a ``TorchDispatchMode``), the
  reference's HBM-traffic proxy.  Eager torch fuses nothing, so every
  elementwise step of a chain reads and writes its tensors in full:
  this count is larger than XLA's, whose fusions keep the chain in
  registers (the reference skips a fusion's inner ops);
* ``dot_bytes`` -- the same for the products alone (the compulsory
  traffic);
* the collectives -- each kind's count and result bytes from the
  ledger of ``distributed.sharding`` (``count_collectives``), weighted
  by the reference's ring factors for ``collective_traffic_bytes``.

A loop runs each of its steps, so a T-step loop counts T times with no
trip-count recovery.  The per-operator tally (:func:`Totals.from_tally`)
is kept beside a dry-run record, so that the roofline can be recomputed
from it without tracing again.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import sharding

# bytes moved over links per byte of result (the reference's ring model)
_TRAFFIC_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0,
                   "reduce-scatter": 1.0, "all-to-all": 1.0,
                   "collective-permute": 1.0}
# the products whose operand and result bytes are ``dot_bytes``
DOT_OPS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm",
           "aten._scaled_mm", "aten.convolution")
# no memory traffic of their own: metadata, allocation without a write,
# and the collectives (counted by the ledger)
_SKIP = {"aten.detach", "aten.alias", "aten.lift_fresh", "aten.empty",
         "aten.empty_like", "aten.empty_strided", "aten.new_empty",
         "aten.new_empty_strided", "aten._local_scalar_dense",
         "aten.sym_size", "aten.sym_stride", "aten.sym_numel"}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


class OpTally(TorchDispatchMode):
    """Per operator (``aten.mm``, ...): its calls, its FLOPs (the
    ``flop_registry`` formula of each call), and the operand plus result
    bytes of those calls (``bytes``; ``dot_bytes`` for the products),
    views, allocations and collectives left out."""

    def __init__(self):
        super().__init__()
        self.ops: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        if func.is_view or name in _SKIP or \
                func.namespace not in ("aten", "prims"):
            return out
        nb = sum(_nbytes(t) for t in tree_leaves((args, kwargs or {}))) + \
            sum(_nbytes(t) for t in tree_leaves(out))
        rec = self.ops.setdefault(name, {"count": 0, "bytes": 0,
                                         "dot_bytes": 0, "flops": 0})
        rec["count"] += 1
        rec["bytes"] += nb
        if name in DOT_OPS:
            rec["dot_bytes"] += nb
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            # ``mm.dtype`` / ``bmm.dtype``: the operands, not the out_dtype
            shaped = args[:2] if func._overloadname == "dtype" else args
            rec["flops"] += int(formula(*shaped, **(kwargs or {}),
                                        out_val=out))
        return out


@dataclasses.dataclass
class Totals:
    """One rank's totals, the reference's ``hlo_analysis.Totals``."""
    flops: float = 0.0
    bytes: float = 0.0
    dot_bytes: float = 0.0
    coll_bytes: dict = dataclasses.field(default_factory=dict)
    coll_counts: dict = dataclasses.field(default_factory=dict)

    @property
    def collective_traffic_bytes(self) -> float:
        return sum(v * _TRAFFIC_FACTOR.get(k, 1.0)
                   for k, v in self.coll_bytes.items())

    @classmethod
    def from_tally(cls, ops: dict, coll_counts: dict,
                   coll_bytes: dict) -> "Totals":
        """The totals of a stored per-operator tally and collective
        ledger (:func:`trace`'s ``tally``)."""
        return cls(flops=float(sum(r["flops"] for r in ops.values())),
                   bytes=float(sum(r["bytes"] for r in ops.values())),
                   dot_bytes=float(sum(r["dot_bytes"]
                                       for r in ops.values())),
                   coll_bytes={k: float(v) for k, v in coll_bytes.items()},
                   coll_counts=dict(coll_counts))


def trace(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` run once with everything it runs on this
    rank counted: returns ``(result, totals, tally)``, ``totals`` a
    :class:`Totals` and ``tally`` ``{"ops": {op: {count, bytes,
    dot_bytes, flops}}, "coll_counts": ..., "coll_bytes": ...}``."""
    tally = OpTally()
    with sharding.count_collectives() as led, tally:
        out = fn(*args, **kwargs)
    return out, Totals.from_tally(tally.ops, led.counts, led.bytes), {
        "ops": tally.ops, "coll_counts": dict(led.counts),
        "coll_bytes": dict(led.bytes)}


# ---------------------------------------------------------------------------
# roofline terms: the H100 in place of the reference's TPU v5e
# ---------------------------------------------------------------------------
# NVIDIA's H100 SXM5 datasheet (the card the port runs on, "NVIDIA H100
# 80GB HBM3", 700 W power limit): 989 TFLOP/s dense bf16 tensor-core
# peak (1979 with 2:4 sparsity), 3.35 TB/s HBM3, NVLink 4 at 900 GB/s
# both directions, 450 GB/s a direction.  A 16 x 16 mesh spans 32
# eight-GPU nodes, so the ``data`` axis crosses nodes (InfiniBand, 50
# GB/s a GPU at 400 Gb/s): the NVLink figure is optimistic for it.
CARD = "NVIDIA H100 80GB HBM3 (SXM5), 700 W"
PEAK_FLOPS = 989e12       # bf16 dense / card
HBM_BW = 3.35e12          # bytes/s / card
LINK_BW = 450e9           # bytes/s / direction, NVLink 4


@dataclasses.dataclass
class Roofline:
    """The reference's ``hlo_analysis.Roofline``: the same properties and
    ``as_dict`` keys, the H100's peaks."""
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    n_devices: int
    dot_bytes_per_device: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def memory_s_lower(self) -> float:
        """Compulsory-traffic bound: only the products' operand and
        result bytes."""
        return self.dot_bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "dot_bytes_per_device": self.dot_bytes_per_device,
            "memory_s_lower": self.memory_s_lower,
            "collective_bytes_per_device": self.collective_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_step_s": self.step_s,
            "n_devices": self.n_devices,
            "card": CARD,
        }

    @classmethod
    def of(cls, totals: Totals, n_devices: int) -> "Roofline":
        return cls(flops_per_device=totals.flops,
                   bytes_per_device=totals.bytes,
                   collective_bytes=totals.collective_traffic_bytes,
                   n_devices=n_devices,
                   dot_bytes_per_device=totals.dot_bytes)
