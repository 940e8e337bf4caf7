"""Plain PyTorch versions of the paged-attention kernels.

Two kinds, as in the JAX package:

* ``paged_attention_ref`` / ``paged_prefill_ref`` -- the plain versions of
  kernels K2 and K3: the same walk over the block table, page by page,
  with the same liveness rule (a dead page's state update is dropped by a
  select, so a NaN-poisoned null page never reaches the output) and the
  same per-row f32 online softmax.  Vectorized over slots, heads and
  queries; the page axis is a Python loop.  The kernel wrappers take them
  for CPU tensors, and ``chip_smoke.py`` holds the kernels against them.

* ``paged_attention_view`` / ``paged_prefill_view`` -- gather the slot's
  pages into logically ordered dense rows, then run the dense attention
  op sequence (:mod:`repro_torch.nn.attention`), so paged serving equals
  the dense cache backend.  The CPU default of ``ops``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.nn import attention

NEG_INF = attention.NEG_INF


def page_live(phys, page_start: int, posn, page_size: int, *, window: int,
              chunked: bool):
    """Whether a page contributes at all: backed (non-null), not wholly
    past ``posn`` and not wholly below the window."""
    live = (phys != 0) & (page_start <= posn)
    page_end = page_start + page_size - 1
    if window > 0 and not chunked:
        live = live & (page_end > posn - window)
    if window > 0 and chunked:
        live = live & (page_end >= torch.div(posn, window,
                                             rounding_mode="floor") * window)
    return live


def pair_mask(pos_k, pos_q, *, window: int, chunked: bool):
    """Attendable (query, key) position pairs, broadcasting."""
    mask = pos_k <= pos_q
    if window > 0 and not chunked:
        mask = mask & (pos_k > pos_q - window)
    if window > 0 and chunked:
        mask = mask & (torch.div(pos_k, window, rounding_mode="floor")
                       == torch.div(pos_q, window, rounding_mode="floor"))
    return mask


def _online_update(s, v, m, l, acc, live):
    """One page's online-softmax step; rows where ``live`` is False keep
    their state (a select, so NaN in a dead page cannot leak)."""
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1, keepdim=True)
    acc_new = acc * corr + v(p)
    return (torch.where(live, m_new, m), torch.where(live, l_new, l),
            torch.where(live, acc_new, acc))


def paged_attention_ref(q, k_pool, v_pool, tables, pos, *, window: int = 0,
                        chunked: bool = False, cap: float = 0.0):
    """Plain version of K2.  q: (B, H, D); k_pool/v_pool: (n_pages + 1,
    page_size, Hkv, D); tables: (B, P); pos: (B,).  Returns (B, H, D) in
    q's dtype."""
    b, h, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qf = q.float().reshape(b, hkv, g, d)
    m = torch.full((b, hkv, g, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=dev)
    posn = pos.long()
    for p in range(tables.shape[1]):
        phys = tables[:, p].long()
        p0 = p * ps
        live = page_live(phys, p0, posn, ps, window=window, chunked=chunked)
        k = k_pool[phys].float()                       # (B, T, Hkv, D)
        v = v_pool[phys].float()
        s = torch.einsum("bhgd,bthd->bhgt", qf, k) * scale
        s = attention.softcap(s, cap)
        pos_k = p0 + torch.arange(ps, device=dev)
        mask = pair_mask(pos_k[None, :], posn[:, None], window=window,
                         chunked=chunked)               # (B, T)
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
        m, l, acc = _online_update(
            s, lambda pr: torch.einsum("bhgt,bthd->bhgd", pr, v), m, l, acc,
            live[:, None, None, None])
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, h, d).to(q.dtype)


def paged_prefill_ref(q, k_pool, v_pool, tables, lens, *, window: int = 0,
                      chunked: bool = False, cap: float = 0.0,
                      q_chunk: int = 16):
    """Plain version of K3.  q: (B, S, H, D) with S a multiple of
    ``q_chunk``; a page is live for a q chunk when backed, not wholly
    above the chunk's last query and not wholly below its window.
    ``lens`` is unused: masking is by position.  Returns (B, S, H, D) in
    q's dtype."""
    del lens
    b, s, h, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    g = h // hkv
    q_chunk = min(q_chunk, s)
    if s % q_chunk:
        raise ValueError(f"S={s} is not a multiple of q_chunk={q_chunk}")
    nc = s // q_chunk
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qf = q.float().reshape(b, nc, q_chunk, hkv, g, d)
    shape = (b, nc, q_chunk, hkv, g)
    m = torch.full(shape + (1,), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(shape + (1,), dtype=torch.float32, device=dev)
    acc = torch.zeros(shape + (d,), dtype=torch.float32, device=dev)
    qc_start = torch.arange(nc, device=dev) * q_chunk            # (C,)
    qc_end = qc_start + q_chunk - 1
    pos_q = torch.arange(s, device=dev).reshape(nc, q_chunk)
    for p in range(tables.shape[1]):
        phys = tables[:, p].long()
        p0 = p * ps
        page_end = p0 + ps - 1
        live = (phys != 0)[:, None] & (p0 <= qc_end)[None, :]   # (B, C)
        if window > 0 and not chunked:
            live = live & (page_end > qc_start - window)[None, :]
        if window > 0 and chunked:
            live = live & (page_end >= (qc_start // window) * window)[None]
        k = k_pool[phys].float()                                 # (B,T,Hkv,D)
        v = v_pool[phys].float()
        sc = torch.einsum("bcqhgd,bthd->bcqhgt", qf, k) * scale
        sc = attention.softcap(sc, cap)
        pos_k = p0 + torch.arange(ps, device=dev)
        mask = pair_mask(pos_k[None, None, :], pos_q[:, :, None],
                         window=window, chunked=chunked)         # (C, Q, T)
        sc = torch.where(mask[None, :, :, None, None, :], sc, NEG_INF)
        m, l, acc = _online_update(
            sc, lambda pr: torch.einsum("bcqhgt,bthd->bcqhgd", pr, v),
            m, l, acc, live[:, :, None, None, None, None])
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, s, h, d).to(q.dtype)


def _gather(pool, tables):
    b = tables.shape[0]
    return pool[tables.long()].reshape(b, -1, pool.shape[2], pool.shape[3])


def paged_attention_view(q, k_pool, v_pool, tables, pos, *, window: int = 0,
                         chunked: bool = False, cap: float = 0.0):
    """Gathered view: pool pages -> dense (B, P * page_size) rows, then
    the dense decode-attention op sequence."""
    out = attention.decode_attention(
        q[:, None], _gather(k_pool, tables), _gather(v_pool, tables), pos,
        window=window, chunked=chunked, cap=cap)
    return out[:, 0]


def paged_prefill_view(q, k_pool, v_pool, tables, lens, *, window: int = 0,
                       chunked: bool = False, cap: float = 0.0):
    """Gathered view: pool pages -> dense (B, P * page_size) KV rows, then
    the dense flash-attention op sequence; real query rows equal the
    dense backend's prefill (the extra tail keys are masked)."""
    del lens  # real rows self-select via the causal mask
    return attention.flash_attention(
        q, _gather(k_pool, tables), _gather(v_pool, tables), causal=True,
        window=window, chunked=chunked, cap=cap)
