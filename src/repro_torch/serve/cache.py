"""Cache backends of the serving stack (``repro.serve.cache``).

The :class:`~repro_torch.serve.engine.InferenceServer` drives a backend:

    alloc(uid, slot, n_prompt) -> CacheHandle     (admission)
    insert(handle, prefill_caches)                (prompt KV -> cache)
    append(handle)                                (one decoded token; may
                                                   allocate a page ->
                                                   raises PoolExhausted)
    gather() -> caches                            (resident tree)
    device_tables() -> (B, P) int32 | None        (paged block tables)
    commit(new_caches) / free(handle)
    can_admit(n_prompt) / memory_report()         (admission contract)

* :class:`DenseCache` -- one dense ``(nsb, max_batch, max_len, ...)``
  buffer per KV tensor; every slot pins ``max_len`` positions.
* :class:`PagedCache` -- a fixed pool of ``page_size``-token pages plus
  per-slot block tables; pages are allocated on admission (prompt + first
  decode write) and lazily on page crossings, freed on retirement.
  Physical page 0 is the null page that unused table entries point at.

The backends' contract is token-for-token invariance: the same request
stream gives identical tokens on either backend, solo or batched.  Cache
tensors are updated in place by the forward, so ``insert`` of a paged
prefill is a pointer swap and ``commit`` stores the same tree.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models import lm


def _insert_slot(big, small, slot: int):
    """Write a per-request tree (leaves ``(nsb, 1, ...)``) into row
    ``slot`` of the resident tree (leaves ``(nsb, max_batch, ...)``),
    from index 0 of every further axis."""
    if isinstance(big, dict):
        for k in big:
            _insert_slot(big[k], small[k], slot)
        return
    idx = (slice(None), slice(slot, slot + 1)) + tuple(
        slice(0, d) for d in small.shape[2:])
    big[idx] = small.to(big.dtype)


class PoolExhausted(RuntimeError):
    """The page pool cannot serve an allocation; the engine reacts by
    preempting a request back to the queue."""


@dataclasses.dataclass
class CacheHandle:
    """One admitted request's cache residency."""

    uid: int
    slot: int                 # decode-batch row / block-table row
    n_tokens: int             # cache positions written so far
    pages: list = dataclasses.field(default_factory=list)


class CacheBackend:
    """Shared bookkeeping; subclasses fill in the storage strategy."""

    name = "abstract"

    def __init__(self, cfg, max_batch: int, max_len: int, device):
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.device = device
        self.caches = None
        self._metrics = None

    def can_admit(self, n_prompt: int) -> bool:
        raise NotImplementedError

    def check_feasible(self, n_prompt: int, max_tokens: int):
        """Raise if the request could never run to completion alone."""

    def alloc(self, uid: int, slot: int, n_prompt: int) -> CacheHandle:
        raise NotImplementedError

    def free(self, handle: CacheHandle):
        raise NotImplementedError

    def append(self, handle: CacheHandle):
        """Advance one decoded token; ensure the next write position is
        backed by storage (may raise :class:`PoolExhausted`)."""
        handle.n_tokens += 1

    def insert(self, handle: CacheHandle, prefill_caches):
        raise NotImplementedError

    def gather(self):
        """The caches tree ``lm.decode_step`` consumes this step."""
        return self.caches

    def device_tables(self):
        """Paged backends: the device-resident (B, P) block tables (None
        for backends that need none)."""
        return None

    def commit(self, new_caches):
        """Store the cache tree a decode step returned."""
        self.caches = new_caches

    def memory_report(self) -> dict:
        raise NotImplementedError

    def bind_metrics(self, registry):
        """Attach a :class:`repro_torch.obs.MetricsRegistry` (or None).
        The engine calls this so ``publish_metrics`` and the pool
        counters have somewhere to write; host-side bookkeeping only --
        no cache tensor is touched."""
        self._metrics = registry if (registry is not None
                                     and registry.enabled) else None

    def publish_metrics(self):
        """Mirror the numeric fields of :meth:`memory_report` into
        ``serve_cache_<key>{backend=...}`` gauges."""
        if self._metrics is None:
            return
        for key, value in self.memory_report().items():
            if isinstance(value, bool) or not isinstance(
                    value, (int, float)):
                continue
            self._metrics.gauge(
                f"serve_cache_{key}",
                f"Cache backend memory_report field {key!r}",
                labels=("backend",)).set(value, backend=self.name)

    def shrink_pool(self, n_pages: int) -> int:
        """Withhold up to ``n_pages`` free pages (page-pool pressure);
        returns how many were withheld (0 without a pool)."""
        return 0

    def restore_pool(self) -> int:
        """Return every withheld page; returns how many came back."""
        return 0

    def reset(self):
        """Drop all residency bookkeeping (buffers may keep stale data;
        every readable position is overwritten before it is unmasked)."""


class DenseCache(CacheBackend):
    """Every decode slot pins a dense ``max_len`` KV row for its whole
    lifetime."""

    name = "dense"

    def __init__(self, cfg, max_batch: int, max_len: int, device):
        super().__init__(cfg, max_batch, max_len, device)
        self.caches = lm.init_caches(cfg, max_batch, max_len, device=device)
        self._bytes = lm.dense_cache_bytes(cfg, max_batch, max_len)
        self._live_tokens = 0
        self._peak_tokens = 0
        self._handles: dict[int, CacheHandle] = {}

    def can_admit(self, n_prompt: int) -> bool:
        return True

    def alloc(self, uid, slot, n_prompt):
        h = CacheHandle(uid=uid, slot=slot, n_tokens=n_prompt)
        self._handles[slot] = h
        self._live_tokens += n_prompt + 1
        self._peak_tokens = max(self._peak_tokens, self._live_tokens)
        return h

    def append(self, handle):
        handle.n_tokens += 1
        self._live_tokens += 1
        self._peak_tokens = max(self._peak_tokens, self._live_tokens)

    def free(self, handle):
        self._handles.pop(handle.slot, None)
        self._live_tokens -= handle.n_tokens + 1
        handle.pages = []

    def insert(self, handle, prefill_caches):
        """Write a request's prefill caches into its slot row: KV
        ``(nsb, 1, S, Hkv, D)`` at positions 0..S-1, Mamba-2 state
        whole."""
        _insert_slot(self.caches, prefill_caches, handle.slot)

    def memory_report(self) -> dict:
        return {
            "backend": self.name,
            "max_batch": self.max_batch,
            "max_len": self.max_len,
            "cache_bytes": self._bytes,
            "peak_cache_bytes": self._bytes,   # dense pins everything
            "live_tokens": self._live_tokens,
            "peak_live_tokens": self._peak_tokens,
            "gather_transient_bytes": 0,
        }

    def reset(self):
        self._handles.clear()
        self._live_tokens = 0
        self._peak_tokens = 0


class PagedCache(CacheBackend):
    """Fixed-size page pool + per-request block tables.

    ``n_pages`` usable pages of ``page_size`` tokens each (plus the null
    page 0).  Admission needs pages for the prompt AND the first decode
    write, with ``reserve_pages`` more free; decode allocates lazily on
    page-boundary crossings via :meth:`append`.
    """

    name = "paged"

    def __init__(self, cfg, max_batch: int, max_len: int, device, *,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 reserve_pages: int = 1):
        super().__init__(cfg, max_batch, max_len, device)
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_len % page_size:
            raise ValueError(
                f"page_size must divide max_len for dense-equivalent "
                f"attention views, got page_size={page_size} "
                f"max_len={max_len}")
        self.page_size = int(page_size)
        self.table_width = max_len // page_size
        if n_pages is None:        # dense-equivalent capacity
            n_pages = max_batch * self.table_width
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.n_pages = int(n_pages)
        self.reserve_pages = max(int(reserve_pages), 0)

        self.caches = lm.init_paged_caches(cfg, max_batch, self.page_size,
                                           self.n_pages, device)
        self._has_kv = any("kv" in c for c in self.caches.values())
        self._table = np.zeros((max_batch, self.table_width), np.int32)
        # device copy of the block tables, patched entry by entry on
        # admission / page allocation / free; decode steps reuse it
        self._table_dev = torch.as_tensor(self._table, device=device)
        self.table_host_uploads = 0
        self._free = collections.deque(range(1, self.n_pages + 1))
        self._withheld: list = []     # pages removed by shrink_pool()
        self._handles: dict[int, CacheHandle] = {}
        self._peak_pages = 0
        self.bytes_per_page = lm.kv_bytes_per_token(cfg) * self.page_size
        self.ssm_slot_bytes = lm.ssm_bytes_per_slot(cfg)
        self.dense_equivalent_bytes = lm.dense_cache_bytes(
            cfg, max_batch, max_len)

    def pages_for(self, n_tokens: int) -> int:
        if not self._has_kv:
            return 0               # pure SSM: state is per slot, no pages
        return -(-max(n_tokens, 0) // self.page_size)

    def _admission_pages(self, n_prompt: int) -> int:
        """Pages covering the prompt + the first decode write (clamped to
        the table width, mirroring :meth:`append`'s max_len clamp)."""
        return self.pages_for(min(n_prompt + 1, self.max_len))

    def can_admit(self, n_prompt: int) -> bool:
        need = self._admission_pages(n_prompt) + self.reserve_pages
        return len(self._free) >= need

    def check_feasible(self, n_prompt: int, max_tokens: int):
        total = min(n_prompt + max_tokens, self.max_len)
        need = self.pages_for(total) + self.reserve_pages
        if need > self.n_pages:
            raise ValueError(
                f"request needs {need} pages (prompt {n_prompt} + "
                f"max_tokens {max_tokens} + reserve {self.reserve_pages}) "
                f"but the pool only has {self.n_pages}; it could never be "
                f"admitted")

    def bind_metrics(self, registry):
        super().bind_metrics(registry)
        if self._metrics is not None:
            # pre-create so the series exists (at 0) even in runs that
            # never exhaust the pool
            self._metrics.counter(
                "serve_pool_exhausted_total",
                "Page-pool allocation failures (each triggers a "
                "preemption in the engine)").inc(0)
            self._gauge_pages()

    def _count_exhausted(self):
        if self._metrics is not None:
            self._metrics.counter("serve_pool_exhausted_total").inc()

    def _gauge_pages(self):
        if self._metrics is not None:
            self._metrics.gauge(
                "serve_pages_in_use",
                "Pages currently allocated out of the pool").set(
                self.pages_in_use)

    def alloc(self, uid, slot, n_prompt):
        n = self._admission_pages(n_prompt)
        if len(self._free) < n:
            self._count_exhausted()
            raise PoolExhausted(
                f"need {n} pages for uid {uid}, {len(self._free)} free")
        h = CacheHandle(uid=uid, slot=slot, n_tokens=n_prompt,
                        pages=[self._free.popleft() for _ in range(n)])
        self._table[slot] = 0
        self._table[slot, :n] = h.pages
        self._table_dev[slot] = torch.as_tensor(self._table[slot])
        self.table_host_uploads += 1
        self._handles[slot] = h
        self._note_usage()
        return h

    def append(self, handle):
        # back the next write position BEFORE advancing the counter: a
        # PoolExhausted raise leaves the handle untouched, so the
        # engine's preempt-and-retry loop can safely call append again
        nxt = handle.n_tokens + 1       # next cache write position
        if nxt < self.max_len and self._has_kv:
            pg = nxt // self.page_size
            if pg >= len(handle.pages):
                if not self._free:
                    self._count_exhausted()
                    raise PoolExhausted(
                        f"uid {handle.uid} needs page {pg}, pool empty")
                phys = self._free.popleft()
                handle.pages.append(phys)
                self._table[handle.slot, pg] = phys
                self._table_dev[handle.slot, pg] = phys
                self._note_usage()
        handle.n_tokens += 1

    def free(self, handle):
        self._free.extend(handle.pages)
        handle.pages = []
        self._table[handle.slot] = 0
        self._table_dev[handle.slot] = 0
        self._handles.pop(handle.slot, None)
        self._gauge_pages()

    def _note_usage(self):
        self._peak_pages = max(self._peak_pages, self.pages_in_use)
        self._gauge_pages()

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free) - len(self._withheld)

    def shrink_pool(self, n_pages: int) -> int:
        # withhold from the BACK of the free deque so page-id reuse order
        # for live traffic is unchanged until the pressure bites
        taken = 0
        while taken < int(n_pages) and self._free:
            self._withheld.append(self._free.pop())
            taken += 1
        self._gauge_pages()
        return taken

    def restore_pool(self) -> int:
        n = len(self._withheld)
        # restore in reverse so the free deque returns to its order
        while self._withheld:
            self._free.append(self._withheld.pop())
        self._gauge_pages()
        return n

    def kv_caches(self):
        """The KV-pool subtree ``{layer: {"kv": {"k","v"}}}`` the paged
        prefill step writes the prompt into, in place; layers without
        attention are absent, so a hybrid's Mamba-2 layers prefill at
        batch 1 from a zero state."""
        return {ln: {"kv": c["kv"]} for ln, c in self.caches.items()
                if "kv" in c}

    def insert(self, handle, prefill_caches):
        """Commit one admitted request's prefill.  KV pools are this
        backend's own, already written in place, so they are a pointer
        swap; Mamba-2 states ``(nsb, 1, ...)`` go into the slot's row, as
        :meth:`DenseCache.insert` puts them."""
        for ln, c in self.caches.items():
            if "kv" in c:
                c["kv"] = prefill_caches[ln]["kv"]
            else:
                _insert_slot(c["mamba"], prefill_caches[ln]["mamba"],
                             handle.slot)

    def device_tables(self):
        return self._table_dev

    def memory_report(self) -> dict:
        in_use = self.pages_in_use
        slots = len(self._handles)
        return {
            "backend": self.name,
            "page_size": self.page_size,
            "n_pages": self.n_pages,
            "pages_in_use": in_use,
            "pages_free": len(self._free),
            "pages_withheld": len(self._withheld),
            "peak_pages_in_use": self._peak_pages,
            "bytes_per_page": self.bytes_per_page,
            "ssm_slot_bytes": self.ssm_slot_bytes,
            "cache_bytes_in_use": in_use * self.bytes_per_page
            + slots * self.ssm_slot_bytes,
            "peak_cache_bytes": self._peak_pages * self.bytes_per_page
            + self.max_batch * self.ssm_slot_bytes,
            "pool_bytes": (self.n_pages + 1) * self.bytes_per_page
            + self.max_batch * self.ssm_slot_bytes,
            "dense_equivalent_bytes": self.dense_equivalent_bytes,
            "gather_transient_bytes": 0,
            "table_bytes": int(self._table_dev.numel()
                               * self._table_dev.element_size()),
            "table_host_uploads": self.table_host_uploads,
        }

    def reset(self):
        for h in list(self._handles.values()):
            self.free(h)
        self._table[:] = 0
        self._table_dev.zero_()
        self.table_host_uploads = 0
        self._free = collections.deque(range(1, self.n_pages + 1))
        self._withheld = []
        self._peak_pages = 0


def make_backend(kind: str, cfg, max_batch: int, max_len: int, device,
                 **kwargs) -> CacheBackend:
    """``kind``: "dense" | "paged" (kwargs: page_size, n_pages,
    reserve_pages)."""
    if kind == "dense":
        if kwargs:
            raise ValueError(f"DenseCache takes no options, got "
                             f"{sorted(kwargs)}")
        return DenseCache(cfg, max_batch, max_len, device)
    if kind == "paged":
        return PagedCache(cfg, max_batch, max_len, device, **kwargs)
    raise ValueError(f"unknown cache backend {kind!r} "
                     f"(expected 'dense' or 'paged')")
