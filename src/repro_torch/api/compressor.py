"""The phase-composition orchestrator (``repro.api.compressor``).

``Compressor`` owns the settings shared by every phase (graph, data
spec, precision sets, batch size, seed, device), runs an arbitrary phase
list, and returns a :class:`CompressionResult` whose centerpiece is the
serializable :class:`~repro_torch.api.plan.CompressionPlan`.

The device is ``cuda`` unless the caller names another; with no card the
constructor raises rather than fall back to the CPU.  On the card the
search turns TF32 off for convolutions and matrix products
(``nn.layers.full_precision``), so it computes in float32 like the
reference.  Checkpoint/resume is not ported yet: ``run(checkpoint=...)``
raises (ROADMAP slice B, queue head).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch.api import phases as phases_mod
from repro_torch.api.plan import CompressionPlan
from repro_torch.device import resolve_device
from repro_torch.models import cnn
from repro_torch.nn import layers
from repro_torch.optim.optimizers import tree_map


@dataclasses.dataclass
class CompressionResult:
    """Outcome of a full phase composition."""

    plan: Optional[CompressionPlan]
    net: Any
    acc_float: Optional[float]
    acc_final: Optional[float]
    size_bytes: Optional[float]
    prune_fraction: Optional[float]
    bits_histogram: Optional[dict]
    timings: dict
    metrics: dict
    total_s: float
    folded: Any = None
    mps_params: Any = None


class Compressor:
    """Drive a list of phase objects over one network + dataset."""

    def __init__(self, graph, spec, *, pw=(0, 2, 4, 8), px=(8,),
                 batch: int = 64, seed: int = 0, device=None):
        if not pw:
            raise ValueError("Compressor: pw must be non-empty")
        if not any(p != 0 for p in pw):
            raise ValueError(f"Compressor: pw must contain at least one "
                             f"nonzero precision, got {tuple(pw)}")
        if any(p < 0 for p in pw):
            raise ValueError(f"Compressor: pw precisions must be >= 0, "
                             f"got {tuple(pw)}")
        if not px or any(p <= 0 for p in px):
            raise ValueError(f"Compressor: px must be non-empty with "
                             f"positive precisions, got {tuple(px)}")
        if batch < 1:
            raise ValueError(f"Compressor: batch must be >= 1, got {batch}")
        self.graph = graph
        self.spec = spec
        self.pw = tuple(int(p) for p in pw)
        self.px = tuple(int(p) for p in px)
        self.batch = int(batch)
        self.seed = int(seed)
        self.device = resolve_device(device)

    def run(self, phases, hooks=(), init_folded=None, checkpoint=None,
            checkpoint_every: int = 50, registry=None) -> CompressionResult:
        if checkpoint is not None:
            raise NotImplementedError(
                "checkpoint/resume is not ported yet (ROADMAP slice B "
                "queue head: checkpoint/, the _CheckpointSaver hook); run "
                "without checkpoint=")
        if registry is not None:
            raise NotImplementedError(
                "the metrics registry is not ported yet (ROADMAP D1); run "
                "without registry=")
        if self.device.type == "cuda":
            layers.full_precision()
        t_start = time.time()
        state = phases_mod.CompressionState(
            graph=self.graph, spec=self.spec, pw=self.pw, px=self.px,
            batch=self.batch, seed=self.seed, device=self.device)
        if init_folded is not None:
            state.folded = tree_map(
                lambda t: torch.as_tensor(t, device=self.device),
                init_folded)
        hooks = list(hooks)
        for phase in phases:
            for h in hooks:
                h.on_phase_start(phase, state)
            t0 = time.time()
            phase.run(state, hooks=hooks)
            key = f"{phase.name}_s"
            state.timings[key] = state.timings.get(key, 0.0) \
                + time.time() - t0
            for h in hooks:
                h.on_phase_end(phase, state)
        return self._result(state, time.time() - t_start)

    def _result(self, state, total_s: float) -> CompressionResult:
        plan = state.plan
        size_bytes = prune_frac = hist = None
        if plan is not None:
            geoms = cnn.cost_geoms(self.graph)
            size_bytes = float(plan.size_bytes(geoms))
            prune_frac = plan.prune_fraction()
            hist = plan.bits_histogram()
        net = state.net if state.net is not None else (
            state.folded if state.folded is not None else state.params)
        return CompressionResult(
            plan=plan, net=net,
            acc_float=state.acc_float, acc_final=state.acc_final,
            size_bytes=size_bytes, prune_fraction=prune_frac,
            bits_histogram=hist, timings=dict(state.timings),
            metrics=dict(state.metrics), total_s=total_s,
            folded=state.folded, mps_params=state.mps_params)
