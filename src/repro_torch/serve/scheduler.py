"""Continuous-batching scheduler: pure bookkeeping, model-agnostic.

The scheduler owns the request queue and the fixed pool of decode slots.
The :class:`~repro.serve.engine.InferenceServer` drives it: every decode
step it first admits pending requests into free slots (the engine prefills
each admitted request and writes its caches into the cache backend), then
runs one batched decode step over the active slots and retires the ones
that finished.  Requests may arrive over time (``Request.arrival`` in
decode steps) -- the streaming-arrivals serving mode -- and more requests
than slots simply queue.

Admission is **memory-aware**: ``pop_admissible`` takes a ``can_admit``
predicate (the cache backend's admission contract -- "do I have pages for
this prompt plus a reservation?").  Admission is strictly FCFS: a
memory-blocked head of queue blocks later requests rather than being
skipped, so big requests cannot starve.  When the pool runs dry
mid-decode the engine **preempts** a running request back to the FRONT of
the queue (:meth:`Scheduler.preempt`); its generated-so-far tokens and
sampling stream travel with it, and re-admission re-prefills
``prompt + generated`` -- exactly the computation the decode loop would
have run, so preemption never changes a request's token stream.

Keeping this free of any jax/model state makes admission, arrival gating,
preemption and slot reuse unit-testable in isolation.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np

from repro_torch.serve.sampling import SamplingParams


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request."""

    uid: int
    prompt: np.ndarray                 # (S0,) int32 token ids
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    arrival: int = 0                   # decode step at which it arrives


@dataclasses.dataclass
class SlotState:
    """Per-slot decode state of an admitted request."""

    request: Request
    slot: int
    pos: int                           # next cache write position
    remaining: int                     # tokens still to sample
    last_token: int
    out: list
    rng: np.random.Generator           # host-fallback sampling stream
    truncated: bool = False
    order: int = 0                     # admission sequence (preemption
    #                                    picks the youngest victim)
    handle: object = None              # CacheHandle of the cache backend


@dataclasses.dataclass
class PendingEntry:
    """A queued request; ``resume`` carries the state of a preempted one."""

    request: Request
    resume: Optional[SlotState] = None

    @property
    def arrival(self) -> int:
        return 0 if self.resume is not None else self.request.arrival

    def tokens(self) -> np.ndarray:
        """What prefill runs on admission: the prompt, extended by the
        already-generated tokens for a preempted request (recompute-style
        resume)."""
        prompt = np.asarray(self.request.prompt, np.int32)
        if self.resume is None:
            return prompt
        return np.concatenate(
            [prompt, np.asarray(self.resume.out, np.int32)])


class Scheduler:
    """Admission + slot lifecycle for a ``max_batch``-slot decode pool.

    ``tracer`` (a :class:`repro.obs.RequestTracer` or None) receives the
    queue-side lifecycle events -- ``enqueued`` / ``preempted`` /
    ``finished``; the engine records the residency-side ones (admitted,
    prefilled, tokens) because only it knows prefill and cache timing.
    """

    def __init__(self, max_batch: int, max_len: int, tracer=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.max_batch = max_batch
        self.max_len = max_len
        self.tracer = tracer
        self.slots: list[Optional[SlotState]] = [None] * max_batch
        self.pending: collections.deque[PendingEntry] = collections.deque()
        self.finished: dict[int, SlotState] = {}
        self.preemptions = 0
        self.preempt_counts: dict[int, int] = {}   # uid -> times preempted

    # ------------------------------------------------------------- submit
    def submit(self, request: Request, *, front: bool = False,
               trace_extra: Optional[dict] = None):
        """Queue a request.  ``front=True`` enqueues at the FRONT of the
        queue -- the fleet's failover path uses it so requests recovered
        from a crashed replica keep their FCFS seniority on the
        survivor.  ``trace_extra`` keys are merged into the ``enqueued``
        lifecycle event (the fleet surfaces retry backoff delays and
        failover causes this way)."""
        prompt = np.asarray(request.prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(f"request {request.uid}: prompt must be a "
                             f"non-empty 1-D token array, got shape "
                             f"{prompt.shape}")
        need = prompt.size + request.sampling.max_tokens
        if need > self.max_len:
            raise ValueError(
                f"request {request.uid}: prompt ({prompt.size}) + "
                f"max_tokens ({request.sampling.max_tokens}) exceeds "
                f"max_len ({self.max_len})")
        if request.uid in self.finished or any(
                s is not None and s.request.uid == request.uid
                for s in self.slots) or any(
                e.request.uid == request.uid for e in self.pending):
            raise ValueError(f"duplicate request uid {request.uid}")
        entry = PendingEntry(request)
        if front:
            self.pending.appendleft(entry)
        else:
            self.pending.append(entry)
        if self.tracer is not None:
            self.tracer.event(request.uid, "enqueued",
                              n=int(prompt.size),
                              arrival=int(request.arrival),
                              **(trace_extra or {}))

    # ---------------------------------------------------------- admission
    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def pop_admissible(self, now: int, can_admit=None):
        """Next ``(entry, slot)`` admissible at decode step ``now``, or
        None.  FIFO among arrived requests; ``can_admit(entry)`` is the
        cache backend's memory gate -- a blocked head of queue blocks the
        queue (strict FCFS, no skip-ahead starvation)."""
        slot = self.free_slot()
        if slot is None:
            return None
        for i, entry in enumerate(self.pending):
            if entry.arrival > now:
                continue
            if can_admit is not None and not can_admit(entry):
                return None            # memory-blocked head: wait
            del self.pending[i]
            return entry, slot
        return None

    def activate(self, slot: int, state: SlotState):
        assert self.slots[slot] is None, f"slot {slot} is busy"
        self.slots[slot] = state

    def complete(self, slot: int):
        state = self.slots[slot]
        assert state is not None, f"slot {slot} is empty"
        self.finished[state.request.uid] = state
        self.slots[slot] = None
        if self.tracer is not None:
            # the engine frees the cache handle before completing, so
            # pages_held is truthfully 0 here
            self.tracer.event(state.request.uid, "finished",
                              n=len(state.out), pages_held=0, slot=slot,
                              truncated=bool(state.truncated))

    def preempt(self, slot: int) -> SlotState:
        """Evict a running request back to the FRONT of the queue.  Among
        successive preemptions the older request ends up ahead (each
        younger victim was pushed first), preserving FCFS on resume."""
        state = self.slots[slot]
        assert state is not None, f"slot {slot} is empty"
        self.slots[slot] = None
        self.pending.appendleft(PendingEntry(state.request, resume=state))
        self.preemptions += 1
        uid = state.request.uid
        self.preempt_counts[uid] = self.preempt_counts.get(uid, 0) + 1
        if self.tracer is not None:
            # the engine frees the victim's pages before preempting
            self.tracer.event(uid, "preempted",
                              n=len(state.out), pages_held=0, slot=slot)
        return state

    def cancel(self, uid: int, kind: str = "cancelled"):
        """Remove a queued or in-flight request.

        Returns ``("pending", entry)`` if it was waiting in the queue,
        ``("active", state)`` if it occupied a decode slot (the caller
        -- the engine -- must have freed its cache handle already), or
        None if the uid is not live.  Emits a ``kind`` lifecycle event
        (``cancelled``/``timeout``, or the fault terminals ``crashed``/
        ``quarantined`` used by the fleet's failover path)."""
        if kind not in ("cancelled", "timeout", "crashed", "quarantined"):
            raise ValueError(f"cancel kind must be 'cancelled', "
                             f"'timeout', 'crashed' or 'quarantined', "
                             f"got {kind!r}")
        for i, entry in enumerate(self.pending):
            if entry.request.uid == uid:
                del self.pending[i]
                out = entry.resume.out if entry.resume is not None else []
                if self.tracer is not None:
                    self.tracer.event(uid, kind, n=len(out), pages_held=0)
                return "pending", entry
        for slot, state in enumerate(self.slots):
            if state is not None and state.request.uid == uid:
                self.slots[slot] = None
                if self.tracer is not None:
                    self.tracer.event(uid, kind, n=len(state.out),
                                      pages_held=0, slot=slot)
                return "active", state
        return None

    def live_uids(self) -> list[int]:
        """Every live uid in FCFS seniority order: active slots by
        admission order first, then the pending queue front-to-back.
        The fleet's crash-recovery path walks this order so re-enqueues
        onto a survivor preserve seniority."""
        actives = sorted(self.active, key=lambda s: s.order)
        return ([s.request.uid for s in actives]
                + [e.request.uid for e in self.pending])

    # ------------------------------------------------------------ queries
    @property
    def active(self) -> list[SlotState]:
        return [s for s in self.slots if s is not None]

    @property
    def has_work(self) -> bool:
        return bool(self.pending) or any(s is not None for s in self.slots)

    @property
    def next_arrival(self) -> Optional[int]:
        if not self.pending:
            return None
        return min(e.arrival for e in self.pending)

    def load(self) -> dict:
        """Queue/slot occupancy snapshot for routers and autoscalers.

        ``*_tokens`` counts tokens still to generate, the unit the
        fleet's queue-wait predictor works in."""
        queued_tokens = 0
        for e in self.pending:
            if e.resume is not None:
                queued_tokens += int(e.resume.remaining)
            else:
                queued_tokens += int(e.request.sampling.max_tokens)
        return {
            "queued": len(self.pending),
            "active": len(self.active),
            "queued_tokens": queued_tokens,
            "active_tokens": sum(int(s.remaining) for s in self.active),
        }
