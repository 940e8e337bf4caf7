"""Dense attention math: the op sequences of ``repro.nn.blocks``'
``flash_attention`` and ``decode_attention``.

These live apart from :mod:`repro_torch.nn.blocks` so the paged-attention
views (``kernels/paged_attention/ref.py``) can run the very same ops on a
gathered pool without an import cycle: a view then equals the dense cache
backend on the same logical rows.  :func:`decode_attention_partial` is
the one-token attention over a rank's block of a cache whose sequence is
split over ranks (``distributed.sharding.merge_partials`` merges the
blocks).
"""
from __future__ import annotations

import math

import torch

from repro_torch.nn.xla_numerics import xla_tanh

NEG_INF = -1e30


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(logits / cap)`` with the JAX package's numbers under
    ``jax.jit``: on float32 logits (the attention scores) the division is
    a multiplication by the float32 reciprocal of ``cap`` and the tanh is
    XLA's on the CPU (:func:`xla_tanh`; ``torch.tanh`` on the card); bf16
    logits (the final softcap) take torch's ops, which round to the same
    bf16 values."""
    if cap <= 0:
        return logits
    if logits.dtype != torch.float32:
        return cap * torch.tanh(logits / cap)
    inv = (torch.tensor(1.0) / torch.tensor(cap, dtype=torch.float32)).item()
    return cap * xla_tanh(logits * inv)


def repeat_kv(kv: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return kv
    b, s, h, d = kv.shape
    return kv[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    chunked: bool = False, cap: float = 0.0,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention. q: (B, S, H, D); k/v: (B, Skv, Hkv, D).

    window > 0 & not chunked -> sliding window (pos_k > pos_q - window);
    window > 0 & chunked -> block-local.  q chunks and their static kv
    ranges, kv chunks and the f32 online softmax follow the JAX op
    sequence.
    """
    b, s, h, d = q.shape
    skv = k.shape[1]
    n_rep = h // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(d)
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, skv)
    if s % q_chunk or skv % kv_chunk:
        raise ValueError(f"lengths ({s}, {skv}) do not tile into chunks "
                         f"({q_chunk}, {kv_chunk})")
    dev = q.device
    outs = []
    for i in range(s // q_chunk):
        q0 = i * q_chunk
        qi = q[:, q0:q0 + q_chunk].float()
        pos_q = q_offset + q0 + torch.arange(q_chunk, device=dev)
        hi = min(q_offset + q0 + q_chunk, skv) if causal else skv
        lo = 0
        if window > 0:
            lo = max(0, (q_offset + q0) - (window - 1)) if not chunked \
                else ((q_offset + q0) // window) * window
        lo = (lo // kv_chunk) * kv_chunk
        hi_pad = min(-(-hi // kv_chunk) * kv_chunk, skv)
        n_kv = max((hi_pad - lo) // kv_chunk, 1)
        lo = min(lo, skv - n_kv * kv_chunk)   # dynamic_slice clamps
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, q_chunk, d), dtype=torch.float32,
                          device=dev)
        for j in range(n_kv):
            p0 = lo + j * kv_chunk
            kj = k[:, p0:p0 + kv_chunk].float()
            vj = v[:, p0:p0 + kv_chunk].float()
            pos_k = p0 + torch.arange(kv_chunk, device=dev)
            sij = torch.einsum("bqhd,bkhd->bhqk", qi, kj) * scale
            sij = softcap(sij, cap)
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= pos_k[None, :] <= pos_q[:, None]
            if window > 0 and not chunked:
                mask &= pos_k[None, :] > pos_q[:, None] - window
            if window > 0 and chunked:
                mask &= (pos_k[None, :] // window) == \
                    (pos_q[:, None] // window)
            sij = torch.where(mask[None, None], sij, NEG_INF)
            m_new = torch.maximum(m, sij.amax(-1))
            p = torch.exp(sij - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vj)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype))
    return torch.cat(outs, dim=1)                        # (B, S, H, D)


def _decode_mask(pos_k, pos, dev, window, chunked):
    """(1|B, S) True where a key position is visible to the token at
    ``pos`` (() or (B,)): causal, then the sliding window or the chunk."""
    posv = torch.as_tensor(pos, device=dev)
    pos_b = posv[None] if posv.dim() == 0 else posv         # (1,) or (B,)
    mask = pos_k[None, :] <= pos_b[:, None]                 # (1|B, S)
    if window > 0 and not chunked:
        mask &= pos_k[None, :] > pos_b[:, None] - window
    if window > 0 and chunked:
        mask &= (pos_k[None, :] // window) == (pos_b[:, None] // window)
    return mask


def decode_attention_partial(q: torch.Tensor, cache_k: torch.Tensor,
                             cache_v: torch.Tensor, pos, *, offset: int = 0,
                             window: int = 0, chunked: bool = False,
                             cap: float = 0.0):
    """One-token attention over a block of the cache: q (B, 1, H, D) every
    query head; cache (B, S_loc, Hkv, D) holding the absolute positions
    ``offset .. offset + S_loc - 1``; ``pos`` () or (B,).  The mask is
    :func:`decode_attention`'s on absolute positions (causal, sliding
    window, chunked).  Returns float32 partials: ``m`` (B, H), the
    largest visible score (``-inf`` where none is visible), ``l`` (B, H),
    the sum of ``exp(score - m)`` (0 there), and ``acc`` (B, H, D), the
    unnormalised output; ``sharding.merge_partials`` merges them over
    the ranks that hold the cache's other blocks."""
    b, s, hkv, d = cache_k.shape
    h = q.shape[2]
    k = repeat_kv(cache_k, h // hkv)
    v = repeat_kv(cache_v, h // hkv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(d)
    logits = softcap(logits, cap)[:, :, 0]                   # (B, H, S)
    mask = _decode_mask(offset + torch.arange(s, device=q.device), pos,
                        q.device, window, chunked)
    logits = torch.where(mask[:, None, :], logits, -math.inf)
    m = logits.amax(dim=-1)                                  # (B, H)
    p = torch.exp(logits - torch.where(torch.isinf(m), 0.0, m)[..., None])
    acc = torch.einsum("bhk,bkhd->bhd", p, v.float())
    return m, p.sum(dim=-1), acc


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, *, window: int = 0,
                     chunked: bool = False, cap: float = 0.0
                     ) -> torch.Tensor:
    """One-token attention. q: (B, 1, H, D); cache: (B, S, Hkv, D);
    pos: () shared index of the current token, (B,) per-slot indices, or
    None to attend over every cached position (a cross attention's
    encoder K/V) with no mask."""
    b, s, hkv, d = cache_k.shape
    h = q.shape[2]
    k = repeat_kv(cache_k, h // hkv)
    v = repeat_kv(cache_v, h // hkv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(d)
    logits = softcap(logits, cap)
    if pos is None:
        p = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    mask = _decode_mask(torch.arange(s, device=q.device), pos, q.device,
                        window, chunked)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
