"""Composable compression phases (paper Sec. 4.4), ``repro.api.phases``
in torch.

The paper's recipe -- warmup -> joint search -> finetune -- as three
phase objects.  Each is a validated config dataclass with a
``run(state, hooks=...)`` method that advances a shared
:class:`CompressionState`; :class:`~repro_torch.api.compressor.Compressor`
chains an arbitrary phase list.  Each of the reference's jitted steps is
an eager torch step here: the loss is built with autograd on fresh leaf
tensors, ``torch.autograd.grad`` takes the gradient of every leaf (zero
for an unused one, as ``jax.grad`` gives), and the functional optimizers
of ``optim/`` return the new tree.  Every random draw goes through the
threefry generator (``core/rng.py``) with the reference's keys, so a run
sees the reference's data and noise.

Hooks observe every phase: ``on_phase_start`` / ``on_step`` /
``on_phase_end``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.api import cost_models
from repro_torch.api.plan import CompressionPlan
from repro_torch.core import costs, discretize, mps, sampling
from repro_torch.core import rng as trng
from repro_torch.data import synthetic
from repro_torch.models import cnn
from repro_torch.optim import optimizers
from repro_torch.optim.optimizers import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# shared training helpers
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels):
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))


def accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, -1) == labels).float())


def merge_bn_stats(opt_params, fwd_params):
    """Take optimizer-updated weights but forward-updated BN stats."""
    out = {}
    for k, p in opt_params.items():
        if "bn" in fwd_params.get(k, {}):
            q = dict(p)
            bn = dict(q["bn"])
            bn["mean"] = fwd_params[k]["bn"]["mean"]
            bn["var"] = fwd_params[k]["bn"]["var"]
            q["bn"] = bn
            out[k] = q
        else:
            out[k] = p
    return out


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(v, it) for k, v in tree.items()}
    return next(it)


def value_and_grad(loss_fn, tree):
    """``jax.value_and_grad(loss_fn, has_aux=True)(tree)`` for a nested
    dict of tensors: returns (loss, aux, grads), the gradient of an
    unused leaf zero."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), tree)
    loss, aux = loss_fn(live)
    flat = tree_leaves(live)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [g if g is not None else torch.zeros_like(x)
             for g, x in zip(grads, flat)]
    return loss.detach(), aux, _unflatten(live, iter(grads))


def _device_of(tree):
    return tree_leaves(tree)[0].device


def evaluate(g, params, spec, mode="float", assignment=None,
             pw=(0, 2, 4, 8), px=(8,), n_batches: int = 8,
             batch: int = 128, folded: bool | None = None) -> float:
    if folded is None:
        folded = mode != "float"
    dev = _device_of(params)
    accs = []
    with torch.no_grad():
        for x, y in synthetic.eval_set(spec, n_batches, batch, device=dev):
            logits, _ = cnn.apply(g, params, x, mode=mode, train=False,
                                  assignment=assignment, pw=pw, px=px,
                                  folded=folded)
            accs.append(float(accuracy(logits, y)))
    return float(np.mean(accs))


def _is_mps_leaf(path, _leaf):
    return "mps" if "mps" in path else "net"


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# state threaded through the phases
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompressionState:
    """Everything a phase may consume or produce."""

    graph: Any
    spec: Any
    pw: tuple[int, ...]
    px: tuple[int, ...]
    batch: int
    seed: int
    device: Any = "cpu"
    params: Any = None          # float params with live BN (warmup output)
    folded: Any = None          # BN-folded net (search input/output)
    mps_params: Any = None      # selection parameters after the search
    plan: Optional[CompressionPlan] = None
    net: Any = None             # final (fine-tuned) network
    acc_float: Optional[float] = None
    acc_final: Optional[float] = None
    timings: dict = dataclasses.field(default_factory=dict)
    metrics: dict = dataclasses.field(default_factory=dict)
    registry: Any = None        # optional repro_torch.obs.MetricsRegistry

    def log_metric(self, phase_name: str, step: int, **values):
        self.metrics.setdefault(phase_name, []).append(
            {"step": int(step), **values})
        if self.registry is not None:
            # the registry's per-(phase, metric) step high-water mark
            # makes this idempotent under checkpoint resume: replayed
            # steps re-log into self.metrics (rebuilt from scratch) but
            # are not double-counted in the registry
            self.registry.emit_phase_point(phase_name, int(step), values)


# ---------------------------------------------------------------------------
# hooks
# ---------------------------------------------------------------------------

class Hook:
    """Per-phase observer; override any subset of the callbacks."""

    def on_phase_start(self, phase, state: CompressionState):
        pass

    def on_step(self, phase, state: CompressionState, step: int,
                metrics: dict, train_state):
        pass

    def on_phase_end(self, phase, state: CompressionState):
        pass


class MetricsLog(Hook):
    """Print (and record) step metrics every ``every`` steps."""

    def __init__(self, every: int = 100, printer=print):
        _check(every >= 1, f"MetricsLog.every must be >= 1, got {every}")
        self.every = every
        self.printer = printer

    def on_step(self, phase, state, step, metrics, train_state):
        if step % self.every:
            return
        vals = {k: float(v) for k, v in metrics.items()}
        state.log_metric(phase.name, step, **vals)
        shown = " ".join(f"{k}={v:.4g}" for k, v in vals.items())
        self.printer(f"  {phase.name} {step}: {shown}")


class PeriodicEval(Hook):
    """Run the phase's quick evaluation every ``every`` steps, with one
    per-phase cache that cache-aware ``quick_eval`` implementations use
    to skip re-discretizing unchanged selection parameters."""

    def __init__(self, every: int = 100, n_batches: int = 2):
        _check(every >= 1, f"PeriodicEval.every must be >= 1, got {every}")
        self.every = every
        self.n_batches = n_batches
        self._caches: dict = {}

    def on_step(self, phase, state, step, metrics, train_state):
        if (step + 1) % self.every:
            return
        quick = getattr(phase, "quick_eval", None)
        if quick is None:
            return
        kwargs = {}
        if "cache" in inspect.signature(quick).parameters:
            kwargs["cache"] = self._caches.setdefault(
                (phase.name, id(phase)), {})
        result = quick(state, train_state, n_batches=self.n_batches,
                       **kwargs)
        if result:
            state.log_metric(phase.name, step + 1, **result)


def _emit(hooks, phase, state, step, metrics, train_state):
    for h in hooks:
        h.on_step(phase, state, step, metrics, train_state)


def _plan_fingerprint(plan) -> str:
    """Content hash of the plan pieces that determine its assignment."""
    h = hashlib.blake2b(digest_size=16)
    for grp in sorted(plan.channel_bits):
        h.update(grp.encode())
        h.update(np.asarray(plan.channel_bits[grp]).tobytes())
    for name in sorted(plan.act_bits):
        h.update(f"{name}={plan.act_bits[name]}".encode())
    for name in sorted(plan.alphas):
        h.update(f"{name}={plan.alphas[name]!r}".encode())
    return h.hexdigest()


def _mps_fingerprint(mps_params) -> str:
    """Content hash of the selection parameters (gamma, delta, alpha)."""
    h = hashlib.blake2b(digest_size=16)
    for field in ("gamma", "delta", "alpha"):
        for name in sorted(mps_params.get(field, {})):
            h.update(name.encode())
            h.update(discretize._host(mps_params[field][name]).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# phase 1: float warmup
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class Warmup:
    """Float training of the full network, then BN folding (phase 1)."""

    steps: int = 300
    lr: float = 1e-3
    weight_decay: float = 1e-4
    name: str = "warmup"

    def __post_init__(self):
        _check(self.steps >= 0, f"Warmup.steps must be >= 0, "
                                f"got {self.steps}")
        _check(self.lr > 0, f"Warmup.lr must be positive, got {self.lr}")
        _check(self.weight_decay >= 0,
               f"Warmup.weight_decay must be >= 0, got {self.weight_decay}")

    def _opt(self):
        return optimizers.adam(self.lr, weight_decay=self.weight_decay)

    def init_train_state(self, state: CompressionState):
        params = state.params if state.params is not None else \
            cnn.init_params(state.graph, trng.key(state.seed, state.device))
        return {"params": params, "opt": self._opt().init(params)}

    def quick_eval(self, state, train_state, n_batches: int = 2):
        acc = evaluate(state.graph, train_state["params"], state.spec,
                       mode="float", n_batches=n_batches)
        return {"acc_float": acc}

    def run(self, state: CompressionState, hooks=(), start_step: int = 0,
            train_state=None):
        g, spec = state.graph, state.spec
        ts = train_state if train_state is not None \
            else self.init_train_state(state)
        opt_w = self._opt()

        for step in range(start_step, self.steps):
            x, y = synthetic.class_batch(spec, step, state.batch,
                                         state.seed, state.device)

            def loss_fn(p):
                logits, new_p = cnn.apply(g, p, x, mode="float", train=True)
                return cross_entropy(logits, y), new_p

            loss, new_p, grads = value_and_grad(loss_fn, ts["params"])
            params, opt_state = opt_w.update(grads, ts["opt"],
                                             ts["params"], step)
            # keep the BN running stats updated by the forward pass
            ts = {"params": merge_bn_stats(params, new_p), "opt": opt_state}
            _emit(hooks, self, state, step, {"loss": loss}, ts)

        state.params = ts["params"]
        state.acc_float = evaluate(g, state.params, spec, mode="float")
        state.folded = cnn.fold_batchnorm(g, state.params)
        return state


# ---------------------------------------------------------------------------
# phase 2: joint pruning + mixed-precision search
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class JointSearch:
    """Joint (weights, gamma, delta, alpha) optimization of
    ``L_task + lambda * R`` on the BN-folded network, then Eq. 7/8
    discretization into a :class:`CompressionPlan` (phase 2).  Every
    weight's Eq. 5 combine runs through kernel K4 on the card
    (``SearchCtx.use_kernel`` left at None)."""

    steps: int = 300
    lam: float = 1e-4
    cost_model: Any = "size"        # registry name or CostModel instance
    sampler: str = sampling.SOFTMAX
    lr_weights: float = 1e-3
    lr_theta: float = 1e-2          # selection params: SGD(0.9)
    weight_decay: float = 1e-4
    tau0: float = 1.0
    tau_end: float = 0.02           # annealed to by the end of the search
    cost_normalize: bool = True     # R / R(all-max-bit) -> lambda is O(1)
    layerwise: bool = False         # EdMIPS-style per-layer assignment
    ne16_refine: bool = False
    gamma_init: Optional[dict] = None
    name: str = "search"

    def __post_init__(self):
        _check(self.steps >= 1,
               f"JointSearch.steps must be >= 1, got {self.steps}")
        _check(self.lam >= 0, f"JointSearch.lam must be >= 0, "
                              f"got {self.lam}")
        _check(self.lr_weights > 0 and self.lr_theta > 0,
               f"JointSearch learning rates must be positive, got "
               f"lr_weights={self.lr_weights}, lr_theta={self.lr_theta}")
        _check(self.tau0 > 0,
               f"JointSearch.tau0 must be positive, got {self.tau0}")
        _check(0 < self.tau_end < self.tau0,
               f"JointSearch temperature must anneal: need "
               f"0 < tau_end < tau0, got tau_end={self.tau_end}, "
               f"tau0={self.tau0}")
        _check(self.sampler in sampling.SAMPLERS,
               f"JointSearch.sampler must be one of {sampling.SAMPLERS}, "
               f"got {self.sampler!r}")

    def _opt(self):
        return optimizers.multi_optimizer(
            _is_mps_leaf,
            {"net": optimizers.adam(self.lr_weights,
                                    weight_decay=self.weight_decay),
             "mps": optimizers.sgd(self.lr_theta, momentum=0.9)})

    def _init_mps(self, state: CompressionState):
        """Initial selection parameters (deterministic)."""
        mps_params = cnn.init_mps_params(state.graph, state.pw, state.px,
                                         layerwise=self.layerwise,
                                         device=state.device)
        if self.gamma_init is not None:
            mps_params = {**mps_params,
                          "gamma": {**mps_params["gamma"],
                                    **{k: torch.as_tensor(
                                        v, dtype=torch.float32,
                                        device=state.device)
                                       for k, v in self.gamma_init.items()}}}
        return mps_params

    def init_train_state(self, state: CompressionState):
        if state.folded is None:
            raise RuntimeError(
                "JointSearch needs a BN-folded network: run a Warmup phase "
                "first or pass init_folded= to Compressor.run()")
        mps_params = self._init_mps(state)
        # Eq. 12 rescale so the effective tensor keeps the warmup magnitude
        ctx0 = mps.SearchCtx(self.sampler, self.tau0,
                             trng.key(state.seed + 1, state.device))
        folded = {
            name: {**p, "w": mps.rescale_weights_for_search(
                p["w"],
                mps_params["gamma"][state.graph.node(name).group()],
                state.pw, ctx0)}
            for name, p in state.folded.items()}
        sp = {"net": folded, "mps": mps_params}
        return {"sp": sp, "opt": self._opt().init(sp)}

    def _cost_scale(self, geoms, cm, state) -> float:
        """1 / R(all-max-bit), evaluated on hard one-hot logits built from
        the initial selection parameters (deterministic softmax)."""
        if not self.cost_normalize:
            return 1.0
        mps_init = self._init_mps(state)
        hard = {}
        for k, v in mps_init["gamma"].items():
            h = torch.full_like(v, -40.0)
            h[..., len(state.pw) - 1] = 40.0
            hard[k] = h
        ctx = mps.SearchCtx(sampling.SOFTMAX, 0.01)
        r_max = float(costs.total_cost(geoms, hard, mps_init["delta"],
                                       state.pw, state.px, ctx, model=cm))
        return 1.0 / max(r_max, 1e-9)

    def quick_eval(self, state, train_state, n_batches: int = 2,
                   cache: Optional[dict] = None):
        sp = train_state["sp"]
        assignment = None
        if cache is not None:
            fp = _mps_fingerprint(sp["mps"])
            if cache.get("fp") == fp:
                assignment = cache["assignment"]
        if assignment is None:
            assignment = discretize.assign(sp["mps"], state.pw, state.px)
            if cache is not None:
                cache["fp"] = fp
                cache["assignment"] = assignment
        acc = evaluate(state.graph, sp["net"], state.spec, mode="quant",
                       assignment=assignment, pw=state.pw, px=state.px,
                       n_batches=n_batches)
        return {"acc_quant": acc}

    def run(self, state: CompressionState, hooks=(), start_step: int = 0,
            train_state=None):
        g, spec = state.graph, state.spec
        if state.acc_float is None and state.folded is not None:
            state.acc_float = evaluate(g, state.folded, spec, mode="float",
                                       folded=True)
        ts = train_state if train_state is not None \
            else self.init_train_state(state)
        geoms = cnn.cost_geoms(g)
        cm = cost_models.get_cost_model(self.cost_model)
        cost_scale = self._cost_scale(geoms, cm, state)
        opt = self._opt()

        base_rng = trng.key(state.seed + 2, state.device)
        tau_decay = (self.tau_end / self.tau0) ** (
            1.0 / max(self.steps - 1, 1))
        for step in range(start_step, self.steps):
            tau = self.tau0 * (tau_decay ** step)
            # fold_in (not sequential split): step k's stream depends on k
            # alone, as the reference's resumable stream does
            ctx = mps.SearchCtx(self.sampler,
                                torch.tensor(tau, dtype=torch.float32,
                                             device=state.device),
                                trng.fold_in(base_rng, step))
            x, y = synthetic.class_batch(spec, 1_000_000 + step, state.batch,
                                         state.seed, state.device)

            def loss_fn(sp):
                logits, _ = cnn.apply(g, sp["net"], x, mode="search",
                                      mps_params=sp["mps"], ctx=ctx,
                                      pw=state.pw, px=state.px, folded=True)
                task = cross_entropy(logits, y)
                reg = costs.total_cost(geoms, sp["mps"]["gamma"],
                                       sp["mps"]["delta"], state.pw,
                                       state.px, ctx,
                                       model=cm) * cost_scale
                return task + self.lam * reg, (task.detach(), reg.detach())

            _, (task, reg), grads = value_and_grad(loss_fn, ts["sp"])
            sp, opt_state = opt.update(grads, ts["opt"], ts["sp"], step)
            ts = {"sp": sp, "opt": opt_state}
            _emit(hooks, self, state, step,
                  {"task": task, "reg": reg, "tau": tau}, ts)

        # ---- discretize (+ optional NE16 refinement) into the plan
        sp = ts["sp"]
        mps_final = sp["mps"]
        if self.layerwise:
            # broadcast the per-layer decision to every channel of the group
            geoms_by_g = {gm.gamma: gm for gm in geoms}
            mps_final = {**mps_final, "gamma": {
                k: v.expand(geoms_by_g[k].cout, v.shape[-1])
                for k, v in mps_final["gamma"].items()}}
        assignment = discretize.assign(mps_final, state.pw, state.px)
        if self.ne16_refine:
            assignment, n_promoted = discretize.ne16_refine(geoms,
                                                            assignment)
            state.timings["ne16_promoted"] = n_promoted
        state.plan = CompressionPlan.from_assignment(
            assignment, state.pw, state.px,
            meta={"cost_model": getattr(cm, "name", str(self.cost_model)),
                  "lam": self.lam, "sampler": self.sampler,
                  "steps": self.steps, "seed": state.seed,
                  "layerwise": self.layerwise,
                  "ne16_refine": self.ne16_refine,
                  "cost_normalize": self.cost_normalize,
                  "acc_float": state.acc_float})
        state.folded = sp["net"]
        state.mps_params = mps_final
        return state


# ---------------------------------------------------------------------------
# phase 3: fine-tune the discretized model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class Finetune:
    """Task-loss-only training of the discretized network (phase 3)."""

    steps: int = 150
    lr: float = 5e-4
    weight_decay: float = 1e-4
    name: str = "finetune"

    def __post_init__(self):
        _check(self.steps >= 0, f"Finetune.steps must be >= 0, "
                                f"got {self.steps}")
        _check(self.lr > 0, f"Finetune.lr must be positive, got {self.lr}")
        _check(self.weight_decay >= 0,
               f"Finetune.weight_decay must be >= 0, "
               f"got {self.weight_decay}")

    def _opt(self):
        return optimizers.adam(self.lr, weight_decay=self.weight_decay)

    def init_train_state(self, state: CompressionState):
        if state.folded is None or state.plan is None:
            raise RuntimeError("Finetune needs a searched network and a "
                               "CompressionPlan: run JointSearch first")
        return {"net": state.folded, "opt": self._opt().init(state.folded)}

    def quick_eval(self, state, train_state, n_batches: int = 2,
                   cache: Optional[dict] = None):
        assignment = None
        if cache is not None:
            fp = _plan_fingerprint(state.plan)
            if cache.get("plan_fp") == fp:
                assignment = cache["assignment"]
        if assignment is None:
            assignment = state.plan.to_assignment(as_tensor=True,
                                                  device=state.device)
            if cache is not None:
                cache["plan_fp"] = fp
                cache["assignment"] = assignment
        acc = evaluate(state.graph, train_state["net"], state.spec,
                       mode="quant", assignment=assignment,
                       pw=state.pw, px=state.px, n_batches=n_batches)
        return {"acc_quant": acc}

    def run(self, state: CompressionState, hooks=(), start_step: int = 0,
            train_state=None):
        g, spec = state.graph, state.spec
        ts = train_state if train_state is not None \
            else self.init_train_state(state)
        assignment = state.plan.to_assignment(as_tensor=True,
                                              device=state.device)
        opt_ft = self._opt()

        for step in range(start_step, self.steps):
            x, y = synthetic.class_batch(spec, 2_000_000 + step, state.batch,
                                         state.seed, state.device)

            def loss_fn(p):
                logits, _ = cnn.apply(g, p, x, mode="quant",
                                      assignment=assignment, folded=True,
                                      pw=state.pw, px=state.px)
                return cross_entropy(logits, y), None

            loss, _, grads = value_and_grad(loss_fn, ts["net"])
            net, opt_state = opt_ft.update(grads, ts["opt"], ts["net"], step)
            ts = {"net": net, "opt": opt_state}
            _emit(hooks, self, state, step, {"loss": loss}, ts)

        state.net = ts["net"]
        state.acc_final = evaluate(g, state.net, spec, mode="quant",
                                   assignment=assignment, pw=state.pw,
                                   px=state.px)
        return state


# ---------------------------------------------------------------------------
# recipe helpers
# ---------------------------------------------------------------------------

def phases_from_config(cfg, gamma_init=None, include_warmup: bool = True):
    """Build the paper's 3-phase recipe from a ``SearchConfig``-like
    object (``warmup_steps``, ``search_steps``, ``finetune_steps``,
    ``lam``, ``cost_model``, ``sampler``, learning rates, temperatures,
    ``cost_normalize``, ``layerwise``, ``ne16_refine``)."""
    phases = []
    if include_warmup:
        phases.append(Warmup(steps=cfg.warmup_steps, lr=cfg.lr_weights))
    phases.append(JointSearch(
        steps=cfg.search_steps, lam=cfg.lam, cost_model=cfg.cost_model,
        sampler=cfg.sampler, lr_weights=cfg.lr_weights,
        lr_theta=cfg.lr_theta, tau0=cfg.tau0, tau_end=cfg.tau_end,
        cost_normalize=cfg.cost_normalize, layerwise=cfg.layerwise,
        ne16_refine=cfg.ne16_refine, gamma_init=gamma_init))
    phases.append(Finetune(steps=cfg.finetune_steps,
                           lr=cfg.lr_weights * 0.5))
    return phases
