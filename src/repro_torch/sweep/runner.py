"""Sweep orchestration: a resumable Pareto-front campaign
(``repro.sweep.runner``).

One :class:`SweepSpec` describes a whole front: the benchmark, the cost
model, an explicit lambda grid plus an adaptive-bisection budget, and the
per-point step recipe.  :class:`SweepRunner` executes the points in lambda
order through the port's search machinery and lands every finished point
in a :class:`~repro_torch.sweep.store.PlanStore`:

* **cnn track** -- phase compositions through
  ``api.compressor.Compressor`` (the paper's warmup -> joint search ->
  finetune recipe on the reference CNNs);
* **lm track** -- the transformer search loop
  (``launch.steps.make_train_step(search=True)`` + ``lm.extract_plan``),
  producing plans the port's ``InferenceServer`` binds directly.

**Warm-start continuation**: point ``i+1`` initializes its weights and
selection parameters from point ``i``'s finished state (persisted per
point through :class:`~repro_torch.checkpoint.checkpoint.
CheckpointManager`, so the chain survives process death) and runs a
reduced search budget (``warm_search_steps``).  Each point derives its
per-step randomness by folding the step index into a seed-keyed base, so
a point resumes bit for bit from its own incremental checkpoint.

**Kill/resume**: finished points are recognized by name in the store
(guarded by the spec hash) and loaded instead of re-run; the in-flight
point resumes from its checkpoint directory.  Loaded metrics equal
freshly computed ones bit for bit, so a killed-and-resumed sweep
reproduces the uninterrupted sweep's store byte for byte -- adaptive
lambdas included, since they are pure functions of the front so far.  On
a CUDA device that needs deterministic algorithms
(``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``).

:class:`SweepSpec` and its :meth:`~SweepSpec.spec_hash` are the JAX
package's field for field, so a spec hashes the same in both packages;
the device a runner uses is not part of the spec.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.api import compressor as compressor_mod
from repro_torch.api import phases as phases_mod
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import registry as configs_registry
from repro_torch.core import mps, sampling
from repro_torch.core import rng as trng
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import cnn, lm
from repro_torch.optim import optimizers
from repro_torch.sweep import front as front_mod
from repro_torch.sweep.store import PlanStore, StoreCorruptError, StoreError

# ---------------------------------------------------------------------------
# cnn-track benchmark registry
# ---------------------------------------------------------------------------

_BENCHES = {}


def register_bench(name: str, builder):
    """Register a cnn-track benchmark: ``builder(width) -> (graph,
    data_spec)``."""
    _BENCHES[name] = builder


def available_benches():
    return tuple(sorted(_BENCHES))


register_bench("gsc", lambda width: (cnn.dscnn(width=width),
                                     synthetic.GSC_LIKE))
register_bench("cifar10", lambda width: (cnn.resnet9(width=width),
                                         synthetic.CIFAR10_LIKE))


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# the sweep contract
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SweepSpec:
    """Everything that determines a sweep's points (hashed into the store
    lineage, so a store can never silently mix two different specs under
    the same entry names)."""

    name: str = "sweep"
    track: str = "cnn"                  # "cnn" | "lm"
    bench: str = "gsc"                  # cnn: bench name; lm: arch name
    cost_model: str = "size"
    lams: tuple = (2.0, 8.0)
    adaptive_points: int = 0            # extra bisection points after grid
    warm_start: bool = True
    warmup_steps: int = 60              # cnn cold points only
    search_steps: int = 60
    warm_search_steps: Optional[int] = None   # default: search_steps // 2
    finetune_steps: int = 30            # cnn track only
    pw: tuple = (0, 2, 4, 8)
    px: tuple = (8,)
    batch: int = 32
    seed: int = 0
    width: int = 8                      # cnn model width
    seq: int = 32                       # lm batch sequence length
    lm_lr: float = 0.05
    eval_batches: int = 4
    checkpoint_every: int = 20

    def __post_init__(self):
        self.lams = tuple(float(l) for l in self.lams)
        self.pw = tuple(int(p) for p in self.pw)
        self.px = tuple(int(p) for p in self.px)
        _check(self.track in ("cnn", "lm"),
               f"SweepSpec.track must be 'cnn' or 'lm', got {self.track!r}")
        _check(len(self.lams) >= 1, "SweepSpec.lams must be non-empty")
        _check(all(l >= 0 for l in self.lams),
               f"SweepSpec.lams must be >= 0, got {self.lams}")
        _check(self.adaptive_points >= 0,
               f"SweepSpec.adaptive_points must be >= 0, "
               f"got {self.adaptive_points}")
        _check(self.search_steps >= 1,
               f"SweepSpec.search_steps must be >= 1, "
               f"got {self.search_steps}")
        _check(self.warmup_steps >= 1,
               f"SweepSpec.warmup_steps must be >= 1, "
               f"got {self.warmup_steps}")
        _check(self.finetune_steps >= 0,
               f"SweepSpec.finetune_steps must be >= 0, "
               f"got {self.finetune_steps}")
        if self.warm_search_steps is not None:
            _check(1 <= self.warm_search_steps,
                   f"SweepSpec.warm_search_steps must be >= 1, "
                   f"got {self.warm_search_steps}")
        _check(self.batch >= 1 and self.eval_batches >= 1,
               f"SweepSpec batch sizes must be >= 1, got "
               f"batch={self.batch}, eval_batches={self.eval_batches}")
        _check(self.checkpoint_every >= 0,
               f"SweepSpec.checkpoint_every must be >= 0, "
               f"got {self.checkpoint_every}")
        if self.track == "lm":
            _check(self.cost_model == "size",
                   f"the lm track optimizes the differentiable size cost; "
                   f"cost_model must be 'size', got {self.cost_model!r}")

    def warm_search(self) -> int:
        if self.warm_search_steps is not None:
            return self.warm_search_steps
        return max(self.search_steps // 2, 1)

    # -------------------------------------------------------- identity
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "SweepSpec":
        return cls(**json.loads(text))

    def spec_hash(self) -> str:
        return hashlib.blake2b(self.to_json().encode(),
                               digest_size=8).hexdigest()


# phase-like shim so Hook observers (and their kill-injection test
# doubles) work on the lm track's flat train loop too
class _LMSearchPhase:
    name = "lm_search"


_LM_PHASE = _LMSearchPhase()


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

class SweepRunner:
    """Execute a :class:`SweepSpec` into a :class:`PlanStore`.

    ``workdir`` holds the per-point checkpoint and warm-start handoff
    directories (``<workdir>/pt<i>/{ckpt,handoff}``); keep it alongside
    the store to make a killed sweep resumable.  ``device`` is ``cuda``
    unless the caller names another (no CPU fallback).  ``registry`` /
    ``tracer`` are optional ``repro_torch.obs`` sinks (``sweep_*``
    metrics, ``point_*`` lifecycle events), the reference's names.
    """

    def __init__(self, spec: SweepSpec, store: PlanStore, workdir: str,
                 *, registry=None, tracer=None, verbose: bool = True,
                 device=None):
        self.spec = spec
        self.store = store
        self.workdir = workdir
        self.verbose = verbose
        self.registry = (registry if registry is not None
                         and registry.enabled else None)
        self.tracer = tracer
        self.device = resolve_device(device)
        if spec.track == "cnn" and spec.bench not in _BENCHES:
            raise ValueError(f"unknown cnn bench {spec.bench!r}; "
                             f"available: {available_benches()}")
        self._graph = None
        self._dspec = None

    # ------------------------------------------------------------ helpers
    def _say(self, msg: str):
        if self.verbose:
            print(f"[sweep] {msg}", flush=True)

    def _count(self, name: str, help_: str, n=1, **labels):
        if self.registry is not None:
            self.registry.counter(name, help_,
                                  labels=tuple(labels)).inc(n, **labels)

    def _trace(self, uid: int, kind: str, **extra):
        if self.tracer is not None:
            self.tracer.event(uid, kind, **extra)

    def point_name(self, index: int) -> str:
        return f"{self.spec.name}.pt{index:02d}"

    def _ptdir(self, index: int, sub: str) -> str:
        return os.path.join(self.workdir, f"pt{index:02d}", sub)

    def _bench(self):
        if self._graph is None:
            self._graph, self._dspec = _BENCHES[self.spec.bench](
                self.spec.width)
        return self._graph, self._dspec

    # ------------------------------------------------- warm-start handoff
    def _save_handoff(self, index: int, tree: dict):
        mgr = CheckpointManager(self._ptdir(index, "handoff"), keep=1)
        mgr.save(0, tree, blocking=True)

    def _load_handoff(self, index: int, template: dict) -> dict:
        mgr = CheckpointManager(self._ptdir(index, "handoff"), keep=1)
        if not mgr.all_steps():
            raise StoreError(
                f"warm start needs the finished state of point {index}, "
                f"but {self._ptdir(index, 'handoff')} is empty -- resume "
                f"with the original workdir, or rerun with "
                f"warm_start=False")
        tree, _ = mgr.restore(0, template)
        return tree

    # --------------------------------------------------------------- run
    def run(self, max_points: Optional[int] = None, hooks=()) -> dict:
        """Run the sweep: the explicit lambda grid in ascending order,
        then up to ``adaptive_points`` bisection points.  ``max_points``
        bounds the number of points *executed* this call (store hits are
        free) -- the kill/resume lever.  Returns the sweep summary."""
        spec = self.spec
        points: list[dict] = []
        executed = loaded = 0
        budget_hit = False
        schedule = [float(l) for l in sorted(spec.lams)]
        index = 0
        while index < len(schedule) + spec.adaptive_points:
            if index >= len(schedule):
                lam = front_mod.next_lambda(self._front(points))
                if lam is None:
                    self._say("adaptive bisection converged")
                    break
                schedule.append(lam)
            lam = schedule[index]
            name = self.point_name(index)
            self._trace(index, "point_enqueued", lam=float(lam))
            point = None
            if self.store.has(name):
                try:
                    point = self._load_point(index, name, lam)
                    loaded += 1
                except StoreCorruptError as e:
                    # a corrupt entry must not kill the whole campaign:
                    # move it aside and recompute the point instead
                    qpath = self.store.quarantine(name)
                    self._say(f"{name}: corrupt store entry ({e}); "
                              f"quarantined to {qpath}, recomputing")
            if point is None:
                if max_points is not None and executed >= max_points:
                    budget_hit = True
                    self._say(f"stopping before {name}: max_points="
                              f"{max_points} executions reached")
                    break
                point = self._execute_point(index, name, lam, points, hooks)
                executed += 1
            points.append(point)
            if self.registry is not None:
                self.registry.gauge(
                    "sweep_front_size",
                    "Points currently on the sweep's Pareto front"
                ).set(len(self._front(points)))
            index += 1

        fr = self._front(points)
        return {
            "spec": spec.spec_hash(),
            "points": [p["name"] for p in points],
            "front": [p["name"] for p in fr],
            "executed": executed,
            "loaded": loaded,
            "complete": not budget_hit,
            "steps_executed": sum(p["steps"] for p in points
                                  if not p["from_store"]),
            "steps_saved": sum(p["saved"] for p in points),
        }

    def _front(self, points) -> list[dict]:
        return front_mod.pareto_front(points)

    # -------------------------------------------------------- store hits
    def _load_point(self, index: int, name: str, lam: float) -> dict:
        entry = self.store.entry(name)
        lin = entry["lineage"]
        if lin.get("spec") != self.spec.spec_hash():
            raise StoreError(
                f"store entry {name!r} was produced by a different "
                f"SweepSpec (spec hash {lin.get('spec')} != "
                f"{self.spec.spec_hash()}): use a fresh store or sweep "
                f"name")
        self._count("sweep_points_completed_total",
                    "Sweep points completed, by origin", source="store")
        self._trace(index, "point_loaded", plan=entry["plan"])
        self._say(f"{name}: loaded from store (lam={lam:g}, "
                  f"score={entry['metrics']['score']:.4f})")
        return self._point_record(entry, from_store=True)

    def _point_record(self, entry: dict, from_store: bool) -> dict:
        lin = entry["lineage"]
        return {
            "name": entry["name"],
            "lam": float(lin["lam"]),
            "score": float(entry["metrics"]["score"]),
            "cost": float(entry["costs"][self.spec.cost_model]),
            "plan": entry["plan"],
            "warm": bool(lin["warm"]),
            "steps": int(lin["steps"]),
            "saved": int(lin["saved"]),
            "from_store": from_store,
        }

    # -------------------------------------------------------- executions
    def _execute_point(self, index: int, name: str, lam: float,
                       points, hooks) -> dict:
        spec = self.spec
        warm = bool(spec.warm_start and index > 0)
        parent = points[-1]["plan"] if warm else None
        self._trace(index, "point_started", lam=float(lam), warm=warm)
        self._count("sweep_points_completed_total",
                    "Sweep points completed, by origin", source="run")
        if warm:
            self._count("sweep_warm_starts_total",
                        "Sweep points initialized from the previous "
                        "point's finished state")
        if spec.track == "cnn":
            plan, metrics, costs, steps, saved = self._run_cnn(
                index, lam, warm, hooks)
        else:
            plan, metrics, costs, steps, saved = self._run_lm(
                index, lam, warm, hooks)
        lineage = {
            "kind": "point", "sweep": spec.name,
            "spec": spec.spec_hash(), "index": index, "lam": float(lam),
            "warm": warm, "parent": parent, "track": spec.track,
            "bench": spec.bench, "cost_model": spec.cost_model,
            "steps": steps, "saved": saved,
        }
        entry = self.store.put(plan, name, metrics=metrics, costs=costs,
                               lineage=lineage)
        self._count("sweep_steps_saved_total",
                    "Search/warmup steps avoided by warm-start "
                    "continuation", n=saved)
        self._trace(index, "point_finished", steps=steps,
                    plan=entry["plan"])
        self._say(f"{name}: lam={lam:g} warm={warm} "
                  f"score={metrics['score']:.4f} "
                  f"cost={costs[spec.cost_model]:.1f} steps={steps}")
        return self._point_record(entry, from_store=False)

    # -------------------------------------------------------- cnn track
    def _cnn_handoff_template(self, g):
        dev = self.device
        folded = cnn.fold_batchnorm(
            g, cnn.init_params(g, trng.key(self.spec.seed, dev)))
        gamma = cnn.init_mps_params(g, self.spec.pw, self.spec.px,
                                    device=dev)["gamma"]
        return {"folded": folded, "gamma": gamma}

    def _run_cnn(self, index: int, lam: float, warm: bool, hooks,
                 gamma_override: Optional[int] = None):
        spec = self.spec
        g, dspec = self._bench()
        comp = compressor_mod.Compressor(g, dspec, pw=spec.pw, px=spec.px,
                                         batch=spec.batch, seed=spec.seed,
                                         device=self.device)
        mgr = CheckpointManager(self._ptdir(index, "ckpt"), keep=3)
        gamma_init = None
        if gamma_override is not None:
            # fixed uniform-precision reference: one-hot every group at
            # the requested bits (the paper's w<bits> baselines)
            j = spec.pw.index(gamma_override)
            gamma_init = {
                grp: np.full(tuple(gm.shape), -40.0, np.float32)
                for grp, gm in cnn.init_mps_params(
                    g, spec.pw, spec.px)["gamma"].items()}
            for grp in gamma_init:
                gamma_init[grp][..., j] = 40.0
        search_kw = dict(lam=lam, cost_model=spec.cost_model)
        if warm:
            # continuation: theta from the previous point's post-search
            # net (init_folded), gamma from its selection logits, at a
            # reduced search budget -- no warmup phase at all
            handoff = self._load_handoff(index - 1,
                                         self._cnn_handoff_template(g))
            phases = [phases_mod.JointSearch(steps=spec.warm_search(),
                                             gamma_init=handoff["gamma"],
                                             **search_kw),
                      phases_mod.Finetune(steps=spec.finetune_steps)]
            res = comp.run(phases, hooks=hooks,
                           init_folded=handoff["folded"], checkpoint=mgr,
                           checkpoint_every=spec.checkpoint_every,
                           registry=self.registry)
            phase_steps = {"search": spec.warm_search(),
                           "finetune": spec.finetune_steps}
            saved = spec.warmup_steps + (spec.search_steps
                                         - spec.warm_search())
        else:
            phases = [phases_mod.Warmup(steps=spec.warmup_steps),
                      phases_mod.JointSearch(steps=spec.search_steps,
                                             gamma_init=gamma_init,
                                             **search_kw),
                      phases_mod.Finetune(steps=spec.finetune_steps)]
            res = comp.run(phases, hooks=hooks, checkpoint=mgr,
                           checkpoint_every=spec.checkpoint_every,
                           registry=self.registry)
            phase_steps = {"warmup": spec.warmup_steps,
                           "search": spec.search_steps,
                           "finetune": spec.finetune_steps}
            saved = 0
        for phase, n in phase_steps.items():
            if n:
                self._count("sweep_search_steps_total",
                            "Training steps executed by sweep points, "
                            "per phase", n=n, phase=phase)
        self._save_handoff(index, {"folded": res.folded,
                                   "gamma": res.mps_params["gamma"]})
        geoms = cnn.cost_geoms(g)
        costs = {"size": front_mod.plan_cost(geoms, res.plan, "size")}
        if spec.cost_model != "size":
            costs[spec.cost_model] = front_mod.plan_cost(
                geoms, res.plan, spec.cost_model)
        metrics = {
            "score": float(res.acc_final),
            "acc_final": float(res.acc_final),
            "acc_float": float(res.acc_float),
            "size_bytes": float(res.size_bytes),
            "prune_fraction": float(res.prune_fraction),
        }
        return (res.plan, metrics, costs,
                sum(phase_steps.values()), saved)

    # --------------------------------------------------------- lm track
    def _lm_init(self, cfg):
        """The LM's parameters at the sweep's seed, with their selection
        logits (``init_params(mps_on=True)``), on the runner's device."""
        gen = torch.Generator(device=self.device).manual_seed(self.spec.seed)
        return lm.init_params(cfg, gen, device=self.device, mps_on=True)

    def _run_lm(self, index: int, lam: float, warm: bool, hooks):
        spec, dev = self.spec, self.device
        cfg = configs_registry.get(spec.bench)
        fresh = self._lm_init(cfg)
        # normalize lambda by the expected size at the (deterministic)
        # fresh init so sweep lambdas are O(1) on both tracks; evaluated
        # on near-hard logits like JointSearch._cost_scale
        with torch.no_grad():
            r_max = float(lm.mps_size_cost(
                cfg, fresh, mps.SearchCtx(sampling.SOFTMAX, 0.01)))
        params = fresh
        if warm:
            params = self._load_handoff(index - 1,
                                        {"params": fresh})["params"]
        del fresh
        opt = optimizers.make_optimizer(cfg.optimizer, spec.lm_lr)
        state = {"params": params, "opt": opt.init(params)}
        del params
        step_fn = steps_lib.make_train_step(cfg, opt, search=True,
                                            lam=lam / max(r_max, 1e-9))
        steps = spec.warm_search() if warm else spec.search_steps
        saved = spec.search_steps - steps if warm else 0

        mgr = CheckpointManager(self._ptdir(index, "ckpt"), keep=2)
        start = 0
        restored, meta = mgr.restore_latest(state)
        if restored is not None:
            state, start = restored, int(meta["step"]) + 1
            self._say(f"{self.point_name(index)}: resumed from "
                      f"step {meta['step']}")
        for step in range(start, steps):
            # lm_batch folds the step index into the seed, so resume
            # replays the identical batches
            batch = synthetic.lm_batch(cfg.vocab, spec.seq + 1,
                                       spec.batch, step, seed=spec.seed,
                                       device=dev)
            p, o, loss = step_fn(state["params"], state["opt"], batch, step)
            state = {"params": p, "opt": o}
            for h in hooks:
                h.on_step(_LM_PHASE, None, step,
                          {"loss": float(loss)}, state)
            if self.registry is not None:
                self.registry.emit_phase_point(
                    "lm_search", step, {"loss": float(loss)})
            if spec.checkpoint_every and (step + 1) \
                    % spec.checkpoint_every == 0 and step + 1 < steps:
                mgr.save(step, state, blocking=True,
                         metadata={"step": step})
        self._count("sweep_search_steps_total",
                    "Training steps executed by sweep points, per phase",
                    n=max(steps - start, 0), phase="lm_search")
        params = state["params"]
        del state
        self._save_handoff(index, {"params": params})

        # score = -eval loss with near-hard selections on held-out
        # deterministic batches (disjoint step ids from training)
        eval_ctx = mps.SearchCtx(sampling.SOFTMAX, 0.02)
        losses = []
        with torch.no_grad():
            for j in range(spec.eval_batches):
                batch = synthetic.lm_batch(cfg.vocab, spec.seq + 1,
                                           spec.batch, 10_000_000 + j,
                                           seed=spec.seed, device=dev)
                losses.append(float(lm.loss_fn(cfg, params, batch,
                                               ctx=eval_ctx, lam=0.0)))
        eval_loss = float(np.mean(losses))

        plan = lm.extract_plan(cfg, params, px=spec.px,
                               meta={"lam": float(lam),
                                     "sweep": spec.name,
                                     "steps": steps})
        size = self._lm_plan_size(cfg, params, plan)
        metrics = {"score": -eval_loss, "eval_loss": eval_loss}
        return plan, metrics, {"size": size}, steps, saved

    @staticmethod
    def _lm_plan_size(cfg, params, plan) -> float:
        """Discrete size (bytes) of an LM plan: sum over groups of
        ``sum(bits) * C_in / 8`` (the discrete face of
        ``lm.mps_size_cost``)."""
        groups = lm.serve_weight_groups(cfg, params)
        total = 0.0
        for grp, bits in plan.channel_bits.items():
            total += float(np.sum(np.asarray(bits))) \
                * groups[grp].shape[1] / 8.0
        return total

    # ---------------------------------------------------------- baselines
    def baseline(self, bits: int, hooks=()) -> dict:
        """Train and store a fixed uniform-``bits`` reference (cnn track):
        the denominator of the paper's iso-accuracy size reductions."""
        spec = self.spec
        if spec.track != "cnn":
            raise ValueError("uniform-precision baselines are cnn-track "
                             "only")
        if bits not in spec.pw:
            raise ValueError(f"baseline bits {bits} not in pw={spec.pw}")
        name = f"{spec.name}.w{bits}ref"
        if self.store.has(name):
            entry = self.store.entry(name)
            if entry["lineage"].get("spec") == spec.spec_hash():
                self._say(f"{name}: loaded from store")
                return entry
        # baselines run cold with lam=0 and a pinned one-hot gamma; use
        # an index far past the sweep points so workdirs never collide
        index = 1000 + spec.pw.index(bits)
        plan, metrics, costs, steps, _ = self._run_cnn(
            index, 0.0, warm=False, hooks=hooks, gamma_override=bits)
        lineage = {"kind": "baseline", "sweep": spec.name,
                   "spec": spec.spec_hash(), "index": index, "lam": 0.0,
                   "warm": False, "parent": None, "track": spec.track,
                   "bench": spec.bench, "cost_model": spec.cost_model,
                   "bits": int(bits), "steps": steps, "saved": 0}
        return self.store.put(plan, name, metrics=metrics, costs=costs,
                              lineage=lineage)

    def iso_report(self, baseline_bits=(8, 2)) -> dict:
        """Iso-accuracy cost-reduction report of the stored front against
        the stored ``w<bits>ref`` baselines (run :meth:`baseline`
        first)."""
        spec = self.spec
        pts = self.store.query(kind="point", sweep=spec.name)
        fr = self.store.front(pts, cost_key=spec.cost_model)
        baselines = {}
        for bits in baseline_bits:
            entry = self.store.entry(f"{spec.name}.w{bits}ref")
            baselines[f"w{bits}"] = (entry["metrics"]["score"],
                                     entry["costs"][spec.cost_model])
        return front_mod.iso_accuracy_report(
            fr, baselines,
            score=lambda e: e["metrics"]["score"],
            cost=lambda e: e["costs"][spec.cost_model])
