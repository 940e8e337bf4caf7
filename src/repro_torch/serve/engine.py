"""Plan-driven serving stack (``repro.serve.engine``).

* :func:`apply_plan` binds a :class:`~repro_torch.api.plan.CompressionPlan`
  into an LM parameter tree: every planned projection becomes a bit-packed
  :class:`~repro_torch.nn.quantized.PackedLinear`.
* :func:`synthetic_plan` and :func:`export_plan_layers` as in the JAX
  package.
* :class:`InferenceServer` -- continuous batching over a dense or paged
  KV cache, with the session API ``begin``/``submit``/``step``/
  ``cancel``/``end``/``serve``.  Paged prefill writes the prompt's KV
  straight into the page pool and runs kernel K3; decode runs K2 over the
  live prefix of the block tables; every planned projection runs K1.  A
  stack with Mamba-2 layers prefills at exact length, their inter-chunk
  recurrence on kernel K5, and keeps one SSM state per slot (beside the
  KV pages for the hybrid, jamba).  An MoE
  stack's expert capacity counts every row of a step (idle decode slots
  and a paged prompt's padding too, as in the JAX package).
* Observability (``obs=`` / :meth:`InferenceServer.attach_obs`): the
  JAX package's ``serve_*`` counters, ``fault_nan_detected_total`` and
  per-request lifecycle events, written at the host boundary only --
  with obs attached the card runs the same kernels, the same number of
  times, with no extra synchronisation.

The cache-backend contract is token-for-token invariance: dense and
paged, solo, batched and preempted, with or without a plan, all emit the
same token streams -- except under MoE, whose capacity-based dropping
depends on the batch by design, and for a preempted hybrid request,
whose recompute prefill runs the chunked SSD where decode ran the
recurrence (as in the JAX package).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.nn import quantized as nnq
from repro_torch.obs import run_summary
from repro_torch.serve import cache as cache_mod
from repro_torch.serve.sampling import (SamplingParams, batch_need_top_k,
                                        make_rng, sample_token,
                                        sample_tokens_device)
from repro_torch.serve.scheduler import Request, Scheduler, SlotState


# ---------------------------------------------------------------------------
# plan binding
# ---------------------------------------------------------------------------

def apply_plan(cfg, params, plan, strict: bool = True):
    """Bind a plan into an LM parameter tree.

    Every plan group (``lm.serve_weight_groups`` naming) has its float
    projection replaced by a :class:`PackedLinear` built from the plan's
    channel bits AND its stored Fig. 3 permutation.  The returned tree
    holds ``blocks`` as a tuple of per-super-block trees (packed shapes
    differ per layer); other leaves (norms, an MoE layer's router and
    expert banks) are sliced per super-block and stay float.  ``strict=False`` leaves groups missing from the plan in float
    instead of raising.
    """
    planned = {f"blocks.{ln}.{sub}.{name}"
               for ln, sub, name in lm._plan_weights(cfg)}
    nsb = lm.n_superblocks(cfg)

    def build(node, path, j):
        if isinstance(node, dict):
            if path in planned:
                group = f"{path}.sb{j}"
                if group in plan.channel_bits:
                    return {"w": nnq.PackedLinear.from_dense(
                        node["w"][j], plan.channel_bits[group],
                        perm=plan.permutations[group])}
                if strict:
                    raise KeyError(
                        f"plan has no group {group!r} (plan groups: "
                        f"{len(plan.channel_bits)}; pass strict=False to "
                        f"serve unplanned projections in float)")
                return {"w": node["w"][j]}
            return {k: build(v, f"{path}.{k}", j)
                    for k, v in node.items() if k != "gamma"}
        return node[j]           # stacked (nsb, ...) leaf -> this block's

    blocks_q = tuple(
        {ln: build(params["blocks"][ln], f"blocks.{ln}", j)
         for ln in params["blocks"]}
        for j in range(nsb))
    out = dict(params)
    out["blocks"] = blocks_q
    return out


def synthetic_plan(cfg, params, bits: int | None = None, seed: int = 0,
                   pw=(0, 2, 4, 8)):
    """A deterministic demo plan over the LM's plan groups: uniform
    ``bits`` everywhere, or (``bits=None``) a seeded random mix drawn
    from ``pw`` -- the JAX package's draws, in its order."""
    from repro_torch.api.plan import CompressionPlan

    rng = np.random.default_rng(seed)
    # favour the higher precisions (linearly), light pruning mass on 0-bit
    weights_p = np.arange(1, len(pw) + 1, dtype=np.float64)
    p = weights_p / weights_p.sum()
    gamma = {}
    for grp, w in lm.serve_weight_groups(cfg, params).items():
        c = w.shape[0]
        if bits is None:
            gamma[grp] = rng.choice(pw, size=c, p=p).astype(np.int64)
        else:
            gamma[grp] = np.full((c,), int(bits), np.int64)
    assignment = {"gamma": gamma, "delta": {}, "alpha": {}}
    return CompressionPlan.from_assignment(
        assignment, pw, (8,), meta={"track": "lm", "arch": cfg.name,
                                    "synthetic": True,
                                    "bits": bits, "seed": seed})


def export_plan_layers(plan, weights: dict) -> dict:
    """Pack every layer of a plan: ``weights`` maps group name ->
    ``(C_out, C_in)`` float tensor.  Returns ``{group: (packed_layers,
    perm, kept)}`` (see ``nn.quantized.pack_channelwise``)."""
    out = {}
    for grp, w in weights.items():
        if grp not in plan.channel_bits:
            raise KeyError(f"group {grp!r} is not in the plan "
                           f"(groups: {sorted(plan.channel_bits)})")
        out[grp] = nnq.pack_channelwise(torch.as_tensor(w),
                                        plan.channel_bits[grp],
                                        perm=plan.permutations[grp])
    return out


# ---------------------------------------------------------------------------
# the serving API
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepResult:
    """What one :meth:`InferenceServer.step` did (see the JAX package):
    ``nan`` means NaN logits were seen and the step's tokens dropped."""

    admitted: list
    produced: dict
    finished: list
    idle: bool = False
    nan: bool = False


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class InferenceServer:
    """Plan-driven LM serving with continuous batching.

    ``plan=None`` serves float weights; a plan switches every planned
    projection to bit-packed quantized execution.  ``cache="paged"``
    serves from a page pool with block tables, memory-aware admission and
    preemption on pool exhaustion.  Runs on ``device`` (default ``cuda``;
    raises when there is none).  Decoder-only token-frontend
    architectures only, as in the reference: enc-dec and the vision /
    audio frontends need prompt-side encoders the request schema does not
    carry.  ``obs`` is a :class:`repro_torch.obs.Observability` bundle
    or None (see :meth:`attach_obs`).
    """

    def __init__(self, cfg, params, plan=None, *, max_len: int = 512,
                 max_batch: int = 8, strict_plan: bool = True,
                 cache: str = "dense", page_size: int = 16,
                 pages: int | None = None, reserve_pages: int = 1,
                 sample_on_device: bool = True, obs=None, device=None):
        if cfg.is_encdec or cfg.frontend != "none":
            raise NotImplementedError(
                f"InferenceServer serves decoder-only token-frontend "
                f"architectures; got {cfg.name} (family={cfg.family}, "
                f"frontend={cfg.frontend})")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.plan = plan
        self.max_len = int(max_len)
        self.max_batch = int(max_batch)
        params = _to_device(params, self.device)
        self.params = params if plan is None else apply_plan(
            cfg, params, plan, strict=strict_plan)
        self.sample_on_device = bool(sample_on_device)
        self.stats: dict = {}
        kwargs = {} if cache == "dense" else {
            "page_size": page_size, "n_pages": pages,
            "reserve_pages": reserve_pages}
        self.backend = cache_mod.make_backend(cache, cfg, self.max_batch,
                                              self.max_len, self.device,
                                              **kwargs)
        self._paged = self.backend.name == "paged"
        # a paged prefill writes the prompt's KV straight into the pool.
        # An attention-only prompt is padded to a q-chunk boundary; a
        # Mamba-2 layer's recurrent state would absorb that padding, so a
        # stack with one (the hybrid) prefills at its exact length.  A
        # pure-SSM stack has no KV pages and takes the dense prefill step
        # on either backend.
        self._has_ssm = any(spec.mixer == "mamba"
                            for spec in lm.block_pattern(cfg))
        self._paged_kv = self._paged and self.backend._has_kv
        self._prefill = steps.make_prefill_step(cfg)
        self._prefill_paged = steps.make_paged_prefill_step(cfg)
        self._decode = steps.make_decode_step(cfg)
        self._step_timing = [0.0, 0.0, 0]
        self._sched = None
        self._now = 0
        self._n_steps = 0
        self._n_admitted = 0
        self._cancelled: dict = {}
        self._nan_detected = False
        # labels of the last admission's prefill on
        # serve_prefill_tokens_total (set by _run_prefill)
        self._prefill_path = "dense"
        self._prefill_width = "dense"
        self.obs = None
        self._reg = None
        self.attach_obs(obs)

    # ------------------------------------------------------- observability
    def attach_obs(self, obs):
        """Attach (or with ``obs=None`` detach) a
        :class:`repro_torch.obs.Observability` bundle.  Instrumentation
        is host-side only: the kernels, their launches and the device
        synchronisation points are the same with or without it."""
        self.obs = obs
        reg = None
        if obs is not None and obs.registry.enabled:
            reg = obs.registry
        self._reg = reg
        self.backend.bind_metrics(reg)

    def metrics_snapshot(self) -> dict:
        """Current metrics + (when tracing) the last serve run's summary;
        ``{}`` when no Observability bundle is attached."""
        if self.obs is None:
            return {}
        self.backend.publish_metrics()
        out = {"metrics": (self.obs.registry.snapshot()
                           if self.obs.registry.enabled else {})}
        if self.obs.tracer is not None:
            out["summary"] = run_summary(self.obs.tracer,
                                         self.obs.registry)
        out["load"] = self.load_report()
        return out

    def _flag_nan(self):
        """Record a NaN detection at the sampling host boundary.  The
        flag makes the current step's tokens untrusted: ``step()``
        discards them and reports ``StepResult.nan``, and ``serve()``
        raises (a solo server has no failover path)."""
        self._nan_detected = True
        if self._reg is not None:
            self._reg.counter(
                "fault_nan_detected_total",
                "NaN logits detected at the sampling host boundary"
            ).inc()

    # ------------------------------------------------------- sampling glue
    def _sample_rows(self, logits, rows, registry=None):
        """One token per row of ``logits`` (R, V_pad), as host ints.
        ``rows`` holds, per row, None (an idle slot) or the triple
        (request, host rng, index of the token in its stream).  Device
        sampling keys each row by (seed, uid, token index); the host
        sampler draws from the rng.  Flags NaN logits.  ``registry``
        counts a sampled (not all-greedy) batch into
        ``serve_topk_sort_steps_total``, as the reference's decode
        does."""
        vals = logits[:, : self.cfg.vocab].float()
        if self.sample_on_device:
            sps = [r[0].sampling for r in rows if r is not None]
            if all(sp.greedy for sp in sps):
                # every row greedy: argmax, none of the sort / Gumbel work
                ids = torch.argmax(vals, dim=-1)
            else:
                args = [torch.as_tensor(v, device=vals.device) for v in zip(
                    *[(0.0, 0, 0, 0, 0) if r is None else
                      (r[0].sampling.temperature, r[0].sampling.top_k,
                       r[0].sampling.seed, r[0].uid, r[2]) for r in rows])]
                ids = sample_tokens_device(
                    vals, *args,
                    need_top_k=batch_need_top_k(sps, self.cfg.vocab,
                                                registry))
            bad = torch.isnan(vals).any()
            ids, bad = ids.cpu().numpy(), bool(bad)
            # NaN logits make the step untrusted: step() discards its
            # tokens and reports StepResult.nan; serve() raises
            if bad:
                self._flag_nan()
            return [int(i) for i in ids]
        host = vals.cpu().numpy()
        if np.isnan(host).any():
            self._flag_nan()
            return [0] * len(rows)
        return [sample_token(host[i], req.sampling, rng)
                for i, (req, rng, _) in enumerate(rows)]

    # ------------------------------------------------------------ serving
    def begin(self, requests=(), *, fresh_trace: bool = True):
        """Open a serving session (per-run trace reset, fresh scheduler,
        cache reset) and submit ``requests``.  ``fresh_trace=False``
        keeps the tracer's events and time origin -- the fleet's
        crash-restore path reopens a struck replica's session without
        erasing its crashed/recovered history."""
        tracer = self.obs.tracer if self.obs is not None else None
        if tracer is not None and fresh_trace:
            tracer.start()          # per-run trace; metrics cumulative
        self._sched = Scheduler(self.max_batch, self.max_len,
                                tracer=tracer)
        self.backend.reset()
        self._step_timing = [0.0, 0.0, 0]
        self._now = 0
        self._n_steps = 0
        self._n_admitted = 0
        self._cancelled = {}
        self._nan_detected = False
        for r in requests:
            self.submit(r)
        return self

    def submit(self, request, *, front: bool = False, trace_extra=None):
        """Enqueue a request into the open session.  ``front=True``
        enqueues at the front of the queue (the fleet's failover keeps
        FCFS seniority so); ``trace_extra`` keys ride on the
        ``enqueued`` trace event."""
        if self._sched is None:
            raise RuntimeError("no open session; call begin() first")
        self.backend.check_feasible(np.asarray(request.prompt).size,
                                    request.sampling.max_tokens)
        self._sched.submit(request, front=front, trace_extra=trace_extra)
        if self._reg is not None:
            self._reg.counter("serve_requests_total",
                              "Requests submitted to serve()").inc()

    @property
    def has_work(self) -> bool:
        return self._sched is not None and self._sched.has_work

    def _admit(self) -> list:
        """Admit every arrived request the backend has memory for;
        returns the admitted uids in admission order."""
        sched, backend = self._sched, self.backend
        reg, tracer = self._reg, (self.obs.tracer
                                  if self.obs is not None else None)
        admitted = []
        while True:
            adm = sched.pop_admissible(
                self._now, can_admit=lambda e: backend.can_admit(
                    e.tokens().size))
            if adm is None:
                break
            entry, slot = adm
            req = entry.request
            resumed = entry.resume is not None
            tokens_np = entry.tokens()
            handle = backend.alloc(req.uid, slot, tokens_np.size)
            if tracer is not None:
                tracer.event(req.uid, "admitted", n=tokens_np.size,
                             pages_held=len(handle.pages), slot=slot,
                             resumed=resumed)
            if reg is not None:
                reg.counter(
                    "serve_admissions_total",
                    "Requests admitted into a decode slot",
                    labels=("resumed",)).inc(
                    resumed="true" if resumed else "false")
            logits = self._run_prefill(backend, handle, tokens_np)
            if tracer is not None:
                tracer.event(req.uid, "prefilled", n=tokens_np.size,
                             pages_held=len(handle.pages), slot=slot)
            if reg is not None:
                # one series per (path, live-table width): the labels of
                # the reference's compiled prefill variants
                reg.counter("serve_prefill_tokens_total",
                            "Tokens run through prefill (resumes "
                            "re-prefill prompt + generated) by prefill "
                            "path and static live-table width",
                            labels=("path", "width")).inc(
                    int(tokens_np.size), path=self._prefill_path,
                    width=self._prefill_width)
            self._n_admitted += 1
            if entry.resume is None:
                rng = make_rng(req.sampling, req.uid)
                tok = self._sample_rows(logits, [(req, rng, 0)])[0]
                st = SlotState(request=req, slot=slot,
                               pos=int(tokens_np.size),
                               remaining=req.sampling.max_tokens - 1,
                               last_token=tok, out=[tok], rng=rng,
                               order=self._n_admitted, handle=handle)
            else:       # preempted request: continue its exact stream
                st = entry.resume
                tok = self._sample_rows(
                    logits, [(req, st.rng, len(st.out))])[0]
                st.slot = slot
                st.pos = int(tokens_np.size)
                st.out.append(tok)
                st.last_token = tok
                st.remaining -= 1
                st.order = self._n_admitted
                st.handle = handle
            if tracer is not None:
                # first residency yields the request's first token; a
                # resume's admission token is a decode step of its stream
                tracer.event(req.uid,
                             "decode" if resumed else "first_token",
                             n=len(st.out),
                             pages_held=len(handle.pages), slot=slot)
            sched.activate(slot, st)
            admitted.append(req.uid)
            if (st.remaining <= 0 or st.pos >= self.max_len) \
                    and not self._nan_detected:
                st.truncated = st.remaining > 0
                backend.free(handle)
                sched.complete(slot)
        return admitted

    def step(self) -> StepResult:
        """One admission + batched-decode round of the open session."""
        if self._sched is None:
            raise RuntimeError("no open session; call begin() first")
        sched, backend = self._sched, self.backend
        tracer = self.obs.tracer if self.obs is not None else None
        fin0 = len(sched.finished)
        admitted = self._admit()
        produced = {}
        for uid in admitted:
            st = sched.finished.get(uid) or next(
                (s for s in sched.active if s.request.uid == uid), None)
            if st is not None:
                produced[uid] = len(st.out)
        if self._nan_detected:
            return StepResult(admitted=admitted, produced=produced,
                              finished=list(sched.finished)[fin0:],
                              nan=True)
        active = sched.active
        idle = False
        if not active:
            nxt = sched.next_arrival
            if nxt is not None:
                self._now = max(self._now + 1, nxt)   # jump to arrival
            idle = True
        else:
            next_toks = self._decode_active(active)
            self._n_steps += 1
            if self._nan_detected:
                return StepResult(admitted=admitted, produced=produced,
                                  finished=list(sched.finished)[fin0:],
                                  nan=True)
            survivors = []
            for st in active:
                st.pos += 1
                tok = next_toks[st.slot]
                st.out.append(tok)
                st.last_token = tok
                st.remaining -= 1
                produced[st.request.uid] = len(st.out)
                if tracer is not None:
                    tracer.event(st.request.uid, "decode", n=len(st.out),
                                 pages_held=len(st.handle.pages),
                                 slot=st.slot)
                if st.remaining <= 0:
                    backend.free(st.handle)
                    sched.complete(st.slot)
                elif st.pos >= self.max_len:
                    st.truncated = True
                    backend.free(st.handle)
                    sched.complete(st.slot)
                else:
                    survivors.append(st)
            # page-backing AFTER every slot recorded its token: a
            # preemption victim then requeues with its full stream
            for st in survivors:
                if sched.slots[st.slot] is st:   # not already preempted
                    self._append_or_preempt(sched, backend, st)
            self._now += 1
        return StepResult(admitted=admitted, produced=produced,
                          finished=list(sched.finished)[fin0:], idle=idle)

    def cancel(self, uid: int, reason: str = "cancelled"):
        """Cancel a queued or in-flight request, freeing its pages.
        Returns the tokens it had generated (possibly empty), or None if
        the uid is not live in the session."""
        if reason not in ("cancelled", "timeout", "crashed",
                          "quarantined"):
            raise ValueError(f"cancel reason must be 'cancelled', "
                             f"'timeout', 'crashed' or 'quarantined', "
                             f"got {reason!r}")
        if self._sched is None:
            raise RuntimeError("no open session; call begin() first")
        sched = self._sched
        for st in sched.active:
            if st.request.uid == uid:
                self.backend.free(st.handle)
                break
        res = sched.cancel(uid, kind=reason)
        if res is None:
            return None
        where, obj = res
        if where == "pending":
            out = obj.resume.out if obj.resume is not None else []
        else:
            out = obj.out
        toks = np.asarray(out, np.int32)
        self._cancelled[uid] = (reason, toks)
        if self._reg is not None:
            self._reg.counter(
                "serve_cancelled_total",
                "Requests removed by cancel(), by reason",
                labels=("reason",)).inc(reason=reason)
        return toks

    def end(self) -> dict:
        """Close the session; returns ``{uid: tokens}`` of every finished
        request and fills ``stats``."""
        sched = self._sched
        if sched is None:
            raise RuntimeError("no open session; call begin() first")
        gather_s, step_s, timed = self._step_timing
        reasons = [r for r, _ in self._cancelled.values()]
        self.stats = {"decode_steps": self._n_steps,
                      "admitted": self._n_admitted,
                      "preemptions": sched.preemptions,
                      "generated": sum(len(s.out)
                                       for s in sched.finished.values()),
                      "cancelled": reasons.count("cancelled"),
                      "timeouts": reasons.count("timeout"),
                      "gather_us_per_step": round(
                          gather_s / timed * 1e6, 2) if timed else 0.0,
                      "step_us_per_step": round(
                          step_s / timed * 1e6, 2) if timed else 0.0,
                      "memory": self.backend.memory_report()}
        self.backend.publish_metrics()
        out = {uid: np.asarray(s.out, np.int32)
               for uid, s in sched.finished.items()}
        self._sched = None
        return out

    def live_uids(self) -> list:
        return [] if self._sched is None else self._sched.live_uids()

    def result(self, uid: int):
        """Finished tokens for ``uid`` in the open session, else None."""
        if self._sched is not None and uid in self._sched.finished:
            return np.asarray(self._sched.finished[uid].out, np.int32)
        return None

    @property
    def preemption_counts(self) -> dict:
        return {} if self._sched is None else dict(
            self._sched.preempt_counts)

    def load_report(self) -> dict:
        """Queue/slot/page occupancy (host bookkeeping only)."""
        if self._sched is not None:
            load = self._sched.load()
        else:
            load = {"queued": 0, "active": 0,
                    "queued_tokens": 0, "active_tokens": 0}
        load["pages_in_use"] = int(
            self.backend.memory_report().get("pages_in_use", 0))
        load["steps"] = self._n_steps
        return load

    def serve(self, requests) -> dict:
        """Run every request to completion with continuous batching;
        returns ``{uid: np.ndarray(tokens)}``."""
        self.begin(requests)
        while self.has_work:
            if self.step().nan:
                self.end()
                raise RuntimeError(
                    "NaN logits detected at the sampling host boundary; "
                    "serving aborted (corrupted parameters or plan?)")
        return self.end()

    def _run_prefill(self, backend, handle, tokens_np):
        """Prefill one admitted request into the backend; returns the
        (1, V_pad) logits of its last real token.  Paged KV: the prompt's
        KV is written straight into the request's pages (kernel K3 on
        CUDA), an attention-only prompt padded to a q-chunk boundary, a
        hybrid one at its exact length (its Mamba-2 layers start from
        zero at batch 1; ``insert`` puts their state in the slot's row).
        Every Mamba-2 layer runs its inter-chunk pass on kernel K5."""
        s = int(tokens_np.size)
        if self._paged_kv:
            q = min(paged_ops.PREFILL_Q, max(8, backend.page_size))
            spad = s if self._has_ssm else -(-s // q) * q
            padded = np.zeros((1, spad), np.int32)
            padded[0, :s] = tokens_np
            width = min(-(-spad // backend.page_size), backend.table_width)
            tables = backend.device_tables()[handle.slot:handle.slot + 1,
                                             :width]
            logits, pcaches = self._prefill_paged(
                self.params,
                {"tokens": torch.as_tensor(padded, device=self.device)},
                backend.kv_caches(), tables,
                torch.tensor([s], dtype=torch.int32, device=self.device))
            self._prefill_path = "paged"
            self._prefill_width = str(width)
        else:
            logits, pcaches = self._prefill(
                self.params, {"tokens": torch.as_tensor(
                    tokens_np[None], device=self.device)})
            self._prefill_path = "dense"
            self._prefill_width = "dense"
        backend.insert(handle, pcaches)
        return logits[:, -1, :]

    def _live_width(self, active):
        """Block-table width covering the highest decode position in the
        batch, bucketed to at most 8 values per table (the JAX package
        compiles one decode variant per width; here it only bounds how
        far attention walks the tables)."""
        if not self._paged:
            return None
        tw = self.backend.table_width
        need = max(st.pos for st in active) // self.backend.page_size + 1
        step = max(1, tw // 8)
        return min(tw, -(-need // step) * step)

    def _decode_active(self, active) -> dict:
        """One batched decode step; returns {slot: sampled token id}."""
        tokens = np.zeros((self.max_batch, 1), np.int32)
        pos = np.zeros((self.max_batch,), np.int32)
        for st in active:
            tokens[st.slot, 0] = st.last_token
            pos[st.slot] = st.pos
        t0 = time.perf_counter()
        caches = self.backend.gather()
        tables = self.backend.device_tables()
        width = self._live_width(active)
        if tables is not None and width < tables.shape[1]:
            tables = tables[:, :width]
        t1 = time.perf_counter()
        logits, caches = self._decode(
            self.params,
            {"tokens": torch.as_tensor(tokens, device=self.device)},
            caches, torch.as_tensor(pos, device=self.device), tables)
        self.backend.commit(caches)
        rows = logits[:, -1, :]
        slots = [st.slot for st in active]
        if self.sample_on_device:
            per_slot = [None] * self.max_batch
            for st in active:
                per_slot[st.slot] = (st.request, st.rng, len(st.out))
            path = "greedy" if all(st.request.sampling.greedy
                                   for st in active) else "sample"
            ids = self._sample_rows(rows, per_slot, self._reg)
            picked = [ids[s] for s in slots]
        else:
            path = "host"
            picked = self._sample_rows(
                rows[slots], [(st.request, st.rng, len(st.out))
                              for st in active])
        t2 = time.perf_counter()
        self._step_timing[0] += t1 - t0
        self._step_timing[1] += t2 - t1
        self._step_timing[2] += 1
        if self._reg is not None:
            # one series per (sampling path, live-table width), the
            # reference's labels
            self._reg.counter(
                "serve_decode_steps_total",
                "Batched decode steps by decode path and static "
                "live-table width",
                labels=("path", "width")).inc(
                path=path, width="dense" if width is None else str(width))
        return dict(zip(slots, picked))

    def _append_or_preempt(self, sched, backend, st):
        """Back the request's next cache write; on pool exhaustion
        preempt the youngest-admitted active request until the append
        succeeds or ``st`` itself was evicted."""
        while True:
            try:
                backend.append(st.handle)
                return
            except cache_mod.PoolExhausted:
                victim = max(sched.active, key=lambda s: s.order)
                backend.free(victim.handle)
                sched.preempt(victim.slot)
                if self._reg is not None:
                    self._reg.counter(
                        "serve_preemptions_total",
                        "Requests preempted back to the queue on pool "
                        "exhaustion").inc()
                if victim is st:
                    return

    def generate(self, prompts: np.ndarray, sampling=None,
                 n_tokens: int | None = None) -> np.ndarray:
        """Batch convenience: (B, S0) prompts -> (B, max_tokens) tokens."""
        prompts = np.asarray(prompts, np.int32)
        b = prompts.shape[0]
        if sampling is None:
            sampling = SamplingParams(max_tokens=n_tokens or 16)
        per = list(sampling) if isinstance(sampling, (list, tuple)) \
            else [sampling] * b
        if len(per) != b:
            raise ValueError(f"got {len(per)} SamplingParams for "
                             f"{b} prompts")
        if len({sp.max_tokens for sp in per}) > 1:
            raise ValueError("generate() needs one max_tokens for every "
                             "prompt; use serve() otherwise")
        res = self.serve([Request(uid=i, prompt=prompts[i], sampling=per[i])
                          for i in range(b)])
        return np.stack([res[i] for i in range(b)])
