"""Transformer building blocks of the dense family (the dense subset of
``repro.nn.blocks``): linear (dense or plan-quantized), RMSNorm, RoPE,
softcap, attention (dense and paged, prefill and decode) and the SwiGLU
FFN.  The dtype flow mirrors the JAX package: bf16 activations and
weights at the point of use, RMSNorm and RoPE angles in f32, attention
scores in f32 with ``-1e30`` masking.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.nn import quantized as nnq
from repro_torch.nn.attention import (decode_attention, flash_attention,
                                      softcap)
from repro_torch.nn.attention import repeat_kv as _repeat_kv

__all__ = ["linear", "rmsnorm", "rope", "softcap", "_repeat_kv",
           "flash_attention", "decode_attention", "paged_decode_attention",
           "paged_prefill_attention", "attention_layer", "ffn_swiglu"]


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """y[..., n] = x[..., k] @ w[k, n]; ``w`` is a dense tensor or a
    :class:`~repro_torch.nn.quantized.PackedLinear` (plan-quantized)."""
    if isinstance(w, nnq.PackedLinear):
        return w(x)
    return torch.matmul(x, w)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); pos: (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = pos[..., None].float() * freqs               # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def paged_decode_attention(q, k_pool, v_pool, tables, pos, *,
                           window: int = 0, chunked: bool = False,
                           cap: float = 0.0):
    """One-token attention straight over the KV page pool.  q: (B, 1, H,
    D); pools (n_pages + 1, page_size, Hkv, D); tables (B, P); pos (B,).
    Kernel K2 on CUDA, the gathered view on the CPU."""
    out = paged_ops.paged_attention(q[:, 0], k_pool, v_pool, tables, pos,
                                    window=window, chunked=chunked, cap=cap)
    return out[:, None]


def paged_prefill_attention(q, k_pool, v_pool, tables, lens, *,
                            window: int = 0, chunked: bool = False,
                            cap: float = 0.0):
    """Prompt attention straight over the KV page pool.  q: (B, S, H, D),
    rows at or past ``lens`` being padding.  Kernel K3 on CUDA, the
    gathered view on the CPU."""
    return paged_ops.paged_prefill_attention(q, k_pool, v_pool, tables,
                                             lens, window=window,
                                             chunked=chunked, cap=cap)


def attention_layer(p: dict, x: torch.Tensor, cfg, *, kind: str = "full",
                    mode: str = "prefill", cache=None, pos=None,
                    effective_w=None, tables=None):
    """kind: full | local | chunked.  mode: prefill | decode.

    Returns (y, new_cache).  Dense: cache = {"k","v"} of (B, S, Hkv, D);
    prefill returns the prompt's K/V as the new cache, decode writes the
    token's K/V at ``pos`` ((B,) per-slot positions, or one shared ()).
    Paged (``tables`` (B, P) given): cache["k"/"v"] are page pools
    (n_pages + 1, page_size, Hkv, D); decode writes the token's K/V into
    its page, prefill scatters the prompt's K/V into the slot's pages
    (``pos`` then holds the (B,) real prompt lengths; padded rows are
    dropped), and attention reads the pool in place.  Every cache write
    is an in-place ``index_put_`` on the pool tensors -- the JAX package
    got the same effect by donating the cache tree to its jitted step.
    """
    if kind not in ("full", "local", "chunked"):
        raise NotImplementedError(
            f"attention kind {kind!r} (bidir/cross attention for enc-dec "
            f"comes with ROADMAP slice C3)")
    b, s, _ = x.shape
    h, hkv, hd = cfg.h_eff, cfg.hkv_eff, cfg.head_dim
    getw = effective_w or (lambda pp: pp["w"])
    q = linear(x, getw(p["wq"])).reshape(b, s, h, hd)
    kk = linear(x, getw(p["wk"])).reshape(b, s, hkv, hd)
    vv = linear(x, getw(p["wv"])).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        kk = rmsnorm(kk, p["k_norm"], cfg.norm_eps)
    window = cfg.local_window if kind in ("local", "chunked") else 0
    chunked = kind == "chunked"
    dev = x.device

    if mode == "decode":
        posn = torch.as_tensor(pos, device=dev)
        pos_rope = posn[None] if posn.dim() == 0 else posn[:, None]
        q = rope(q, pos_rope, cfg.rope_theta)
        kk = rope(kk, pos_rope, cfg.rope_theta)
        rows = torch.arange(b, device=dev)
        if cache is not None and tables is not None:
            page_size = cache["k"].shape[1]
            pos_b = posn.expand(b) if posn.dim() == 0 else posn
            phys = tables[rows, torch.div(pos_b, page_size,
                                          rounding_mode="floor")].long()
            off = pos_b.long() % page_size
            cache["k"][phys, off] = kk[:, 0].to(cache["k"].dtype)
            cache["v"][phys, off] = vv[:, 0].to(cache["v"].dtype)
            out = paged_decode_attention(
                q, cache["k"], cache["v"], tables, pos_b.to(torch.int32),
                window=window, chunked=chunked, cap=cfg.attn_softcap)
        else:
            if cache is not None:
                if posn.dim() == 0:
                    cache["k"][:, posn] = kk[:, 0].to(cache["k"].dtype)
                    cache["v"][:, posn] = vv[:, 0].to(cache["v"].dtype)
                else:
                    cache["k"][rows, posn.long()] = kk[:, 0].to(
                        cache["k"].dtype)
                    cache["v"][rows, posn.long()] = vv[:, 0].to(
                        cache["v"].dtype)
                ck, cv = cache["k"], cache["v"]
            else:
                ck, cv = kk, vv
            out = decode_attention(q, ck, cv, posn, window=window,
                                   chunked=chunked, cap=cfg.attn_softcap)
        new_cache = cache if cache is not None else {"k": ck, "v": cv}
    elif mode == "prefill":
        positions = torch.arange(s, device=dev)
        q = rope(q, positions, cfg.rope_theta)
        kk = rope(kk, positions, cfg.rope_theta)
        if cache is not None and tables is not None:
            page_size = cache["k"].shape[1]
            lens_b = torch.as_tensor(pos, device=dev).reshape(-1).expand(b)
            pg = torch.clamp(torch.div(positions, page_size,
                                       rounding_mode="floor"),
                             max=tables.shape[1] - 1)
            phys = tables[:, pg].long()                            # (B, S)
            off = (positions % page_size).expand(b, s)
            # rows at or past lens are padding: never written, so the
            # pool (and the shared null page) holds only real tokens
            keep = positions[None, :] < lens_b[:, None]
            cache["k"][phys[keep], off[keep]] = kk[keep].to(cache["k"].dtype)
            cache["v"][phys[keep], off[keep]] = vv[keep].to(cache["v"].dtype)
            new_cache = cache
            out = paged_prefill_attention(
                q, cache["k"], cache["v"], tables, lens_b.to(torch.int32),
                window=window, chunked=chunked, cap=cfg.attn_softcap)
        else:
            out = flash_attention(q, kk, vv, causal=True, window=window,
                                  chunked=chunked, cap=cfg.attn_softcap)
            new_cache = {"k": kk, "v": vv}
    else:
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")

    y = linear(out.reshape(b, s, h * hd), getw(p["wo"]))
    return y, new_cache


def ffn_swiglu(p: dict, x: torch.Tensor, effective_w=None) -> torch.Tensor:
    getw = effective_w or (lambda pp: pp["w"])
    g = linear(x, getw(p["w_gate"]))
    u = linear(x, getw(p["w_up"]))
    # silu with the logistic written out as 1 / (1 + exp(-g)), each op
    # rounded to the activation dtype: the JAX package's jax.nn.silu as
    # XLA expands it, which torch.sigmoid's single rounding is not
    return linear(g * (1 / (1 + torch.exp(-g))) * u, getw(p["w_down"]))
