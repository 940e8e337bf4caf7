"""The phase-composition orchestrator (``repro.api.compressor``).

``Compressor`` owns the settings shared by every phase (graph, data
spec, precision sets, batch size, seed, device), runs an arbitrary phase
list, and returns a :class:`CompressionResult` whose centerpiece is the
serializable :class:`~repro_torch.api.plan.CompressionPlan`.

The device is ``cuda`` unless the caller names another; with no card the
constructor raises rather than fall back to the CPU.  On the card the
search turns TF32 off for convolutions and matrix products
(``nn.layers.full_precision``), so it computes in float32 like the
reference.

Checkpoint/resume rides on :class:`~repro_torch.checkpoint.checkpoint.
CheckpointManager`, in the reference's scheme: ``run(checkpoint=mgr)``
saves the in-flight train state every ``checkpoint_every`` steps plus a
carry snapshot at every phase boundary, and a later ``run`` with the same
manager resumes from the newest readable checkpoint.  Every phase folds
the step index into a seed-keyed threefry base, so a resumed run replays
the stream of the run it continues and gives the same plan.  In-phase
checkpoints are incremental: each phase start writes one pinned full
snapshot of the carry (folded net / final net / plan / selection
parameters), and periodic saves store the train state plus only the
carry leaves that changed since that snapshot.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.api import phases as phases_mod
from repro_torch.api.plan import CompressionPlan
from repro_torch.checkpoint import checkpoint as checkpoint_mod
from repro_torch.core import rng as trng
from repro_torch.device import resolve_device
from repro_torch.models import cnn
from repro_torch.nn import layers
from repro_torch.optim.optimizers import tree_map

_PHASE_STRIDE = 1_000_000    # checkpoint step tag = phase_index*stride+step


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

    def as_legacy_dict(self) -> dict:
        """The result dict shape of the deprecated ``run_pipeline``."""
        return {
            "acc_float": self.acc_float,
            "acc_final": self.acc_final,
            "size_bytes": self.size_bytes,
            "prune_fraction": self.prune_fraction,
            "bits_histogram": self.bits_histogram,
            "assignment": self.plan.to_assignment()
            if self.plan is not None else None,
            "net": self.net,
            "timings": self.timings,
            "total_s": self.total_s,
        }


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
        """``registry`` (a :class:`repro_torch.obs.MetricsRegistry`)
        routes the phases' step metrics and timings into the shared
        observability namespace -- the same registry the serving stack
        writes into.  Hook-logged step metrics become
        ``compress_step_value`` / ``compress_step_points_total{phase,
        metric}`` (idempotent under checkpoint resume when the same
        registry is reused), and each phase's wall time lands in
        ``compress_phase_seconds{phase}``."""
        if self.device.type == "cuda":
            layers.full_precision()
        t_start = time.time()
        state = phases_mod.CompressionState(
            graph=self.graph, spec=self.spec, pw=self.pw, px=self.px,
            batch=self.batch, seed=self.seed, device=self.device)
        if registry is not None and registry.enabled:
            state.registry = registry
        if init_folded is not None:
            state.folded = tree_map(
                lambda t: torch.as_tensor(t, device=self.device),
                init_folded)
        phases = list(phases)
        hooks = list(hooks)

        start_phase, start_step, resumed_train = 0, 0, None
        if checkpoint is not None:
            resumed = self._try_resume(checkpoint, phases, state)
            if resumed is not None:
                start_phase, start_step, resumed_train = resumed

        for i, phase in enumerate(phases):
            if i < start_phase:
                continue
            phase_hooks = hooks
            if checkpoint is not None:
                phase_hooks = hooks + [_CheckpointSaver(
                    checkpoint, checkpoint_every, i,
                    is_last=(i == len(phases) - 1))]
            for h in phase_hooks:
                h.on_phase_start(phase, state)
            t0 = time.time()
            phase.run(state, hooks=phase_hooks,
                      start_step=start_step if i == start_phase else 0,
                      train_state=resumed_train if i == start_phase
                      else None)
            key = f"{phase.name}_s"
            state.timings[key] = state.timings.get(key, 0.0) \
                + time.time() - t0
            if state.registry is not None:
                state.registry.gauge(
                    "compress_phase_seconds",
                    "Cumulative wall time spent in a compression phase",
                    labels=("phase",)).set(state.timings[key],
                                           phase=phase.name)
            for h in phase_hooks:
                h.on_phase_end(phase, state)
        if checkpoint is not None:
            checkpoint.wait()
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

    # -------------------------------------------------------------- resume
    def _try_resume(self, manager, phases, state):
        """Resume from the newest checkpoint that restores cleanly; an
        unreadable file or a template mismatch (e.g. an edited phase
        list) falls back to the next-older checkpoint."""
        for tag in reversed(manager.all_steps()):
            try:
                meta = manager.peek_meta(tag)
                i = int(meta.get("phase_index", 0))
                step = int(meta.get("phase_step", 0))
                if i >= len(phases):
                    continue
                carry = self._restore_carry(manager, tag, meta)
                self._apply_carry(state, carry, meta)
                if meta.get("boundary"):
                    return (i, 0, None)
                train_tmpl = phases[i].init_train_state(state)
                restored, _ = manager.restore(tag, {"train": train_tmpl})
                return (i, step, restored["train"])
            except Exception as e:  # corrupt/mismatched: try an older one
                print(f"[compressor] cannot resume from checkpoint {tag}: "
                      f"{e}")
        return None

    def _restore_carry(self, manager, tag, meta) -> dict:
        """The carry of one checkpoint: in full for a boundary save, else
        the pinned phase-start base plus the saved delta leaves."""
        base_tag = meta.get("carry_base_tag")
        if base_tag is None:       # boundary save
            restored, _ = manager.restore(
                tag, {"carry": self._carry_template(meta)})
            return restored["carry"]
        base_meta = manager.peek_meta(base_tag)
        restored, _ = manager.restore(
            base_tag, {"carry": self._carry_template(base_meta)})
        carry = dict(restored["carry"])
        delta_keys = meta.get("carry_delta_keys") or []
        if delta_keys:
            full_tmpl = self._carry_template(meta)
            restored, _ = manager.restore(
                tag, {"carry_delta": {k: full_tmpl[k] for k in delta_keys}})
            carry.update(restored["carry_delta"])
        # keys the phase dropped since the base snapshot
        carry = {k: v for k, v in carry.items() if meta.get(f"has_{k}")}
        manager.pin(base_tag)      # a fresh manager must not GC the base
        return carry

    def _folded_template(self):
        params = cnn.init_params(self.graph, trng.key(self.seed,
                                                      self.device))
        return cnn.fold_batchnorm(self.graph, params)

    def _plan_template(self):
        mps_params = cnn.init_mps_params(self.graph, self.pw, self.px)
        tree = {"bits": {}, "perm": {}}
        for grp, gamma in mps_params["gamma"].items():
            c = int(gamma.shape[0])
            tree["bits"][grp] = np.zeros((c,), np.int64)
            tree["perm"][grp] = np.zeros((c,), np.int64)
        return tree

    def _carry_template(self, meta) -> dict:
        carry = {}
        if meta.get("has_folded"):
            carry["folded"] = self._folded_template()
        if meta.get("has_net"):
            carry["net"] = self._folded_template()
        if meta.get("has_plan"):
            carry["plan"] = self._plan_template()
        if meta.get("has_mps"):
            carry["mps"] = cnn.init_mps_params(self.graph, self.pw, self.px,
                                               device=self.device)
        return carry

    def _apply_carry(self, state, carry, meta):
        # unconditional assignment: a failed resume attempt from a newer
        # checkpoint must not leak state into the fallback attempt
        state.folded = carry.get("folded")
        state.net = carry.get("net")
        state.mps_params = carry.get("mps")
        state.plan = CompressionPlan.from_tree(
            carry["plan"], meta["plan_scalars"]) if "plan" in carry else None
        state.acc_float = float(meta["acc_float"]) \
            if meta.get("acc_float") is not None else None
        for key, value in (meta.get("timings") or {}).items():
            state.timings.setdefault(key, value)


class _CheckpointSaver(phases_mod.Hook):
    """Internal hook: one pinned full carry snapshot at phase start, then
    periodic in-phase saves of the train state + only the carry leaves
    that changed against that snapshot (usually none), and a full carry
    snapshot at the phase boundary."""

    def __init__(self, manager, every: int, phase_index: int,
                 is_last: bool):
        self.manager = manager
        self.every = every
        self.phase_index = phase_index
        self.is_last = is_last
        self._base_flat: dict[str, dict] = {}
        # strong refs to the carry objects captured in the base: phases
        # REPLACE carry entries rather than mutating them, so object
        # identity proves a key unchanged without flattening it (the refs
        # keep `is` sound -- CPython reuses addresses of dead objects)
        self._base_objs: dict[str, object] = {}

    def _carry(self, state) -> dict:
        carry = {}
        if state.folded is not None:
            carry["folded"] = state.folded
        if state.net is not None:
            carry["net"] = state.net
        if state.plan is not None:
            carry["plan"] = state.plan.to_tree()
        if state.mps_params is not None:
            # the sweep's warm-start handoff rides on the final selection
            # parameters: a run resumed past JointSearch still reports them
            carry["mps"] = state.mps_params
        return carry

    def _meta(self, state, phase_index: int, phase_step: int,
              boundary: bool) -> dict:
        return {
            "phase_index": phase_index,
            "phase_step": phase_step,
            "boundary": boundary,
            "has_folded": state.folded is not None,
            "has_net": state.net is not None,
            "has_plan": state.plan is not None,
            "has_mps": state.mps_params is not None,
            "plan_scalars": state.plan.scalars()
            if state.plan is not None else None,
            "acc_float": state.acc_float,
            "timings": {k: v for k, v in state.timings.items()
                        if isinstance(v, (int, float))},
        }

    @property
    def _base_tag(self) -> int:
        return self.phase_index * _PHASE_STRIDE

    def on_phase_start(self, phase, state):
        if self.every <= 0:
            return
        carry = self._carry(state)
        self._base_objs = dict(carry)
        existing = self._load_base_flat()
        if existing is not None:
            # a resumed run re-enters the phase: older delta checkpoints
            # reference the pinned base on disk -- reuse it, and compare
            # deltas against the disk content, not the resumed carry
            self._base_flat = existing
            self._base_objs = {}
            self.manager.pin(self._base_tag)
            return
        self._base_flat = {k: checkpoint_mod._flatten(v)
                           for k, v in carry.items()}
        self.manager.save(
            self._base_tag, {"carry": carry}, blocking=False,
            metadata=self._meta(state, self.phase_index, 0, boundary=True),
            pin=True)

    def _load_base_flat(self):
        """The base snapshot's carry as {key: {leaf_path: array}}, read
        straight from disk (None if absent/unreadable)."""
        self.manager.wait()            # join any in-flight boundary write
        try:
            with np.load(self.manager._fname(self._base_tag),
                         allow_pickle=False) as z:
                out: dict[str, dict] = {}
                for key in z.files:
                    if not key.startswith("carry/"):
                        continue
                    top, _, leaf = key[len("carry/"):].partition("/")
                    out.setdefault(top, {})[leaf] = z[key]
                return out or None
        except Exception:
            return None

    def _delta_keys(self, carry: dict) -> list[str]:
        changed = []
        for k, v in carry.items():
            if self._base_objs.get(k) is v:
                continue               # same object the base captured
            base = self._base_flat.get(k)
            if base is None:
                changed.append(k)
                continue
            flat = checkpoint_mod._flatten(v)
            if set(flat) != set(base) or any(
                    not np.array_equal(flat[p], base[p]) for p in flat):
                changed.append(k)
            else:
                self._base_objs[k] = v   # equal content: skip the compare
                #                          on later saves
        return changed

    def on_step(self, phase, state, step, metrics, train_state):
        if self.every <= 0 or (step + 1) % self.every:
            return
        carry = self._carry(state)
        delta_keys = self._delta_keys(carry)
        meta = self._meta(state, self.phase_index, step + 1,
                          boundary=False)
        meta["carry_base_tag"] = self._base_tag
        meta["carry_delta_keys"] = delta_keys
        tag = self.phase_index * _PHASE_STRIDE + step + 1
        self.manager.save(
            tag,
            {"train": train_state,
             "carry_delta": {k: carry[k] for k in delta_keys}},
            blocking=False, metadata=meta)

    def on_phase_end(self, phase, state):
        if self.is_last or self.every <= 0:
            return
        tag = (self.phase_index + 1) * _PHASE_STRIDE
        self.manager.save(
            tag, {"carry": self._carry(state)}, blocking=False,
            metadata=self._meta(state, self.phase_index + 1, 0,
                                boundary=True), pin=True)
