"""Building blocks of the dense, MoE, pure-SSM and enc-dec families (a
subset of ``repro.nn.blocks``): linear (dense or plan-quantized), RMSNorm,
RoPE, softcap, attention (dense and paged, prefill and decode; causal,
windowed, bidirectional and cross), the SwiGLU FFN,
the top-k MoE with capacity-based token dropping (single device) and the
Mamba-2 SSD mixer, whose prefill runs its inter-chunk recurrence on
kernel K5 (``kernels/ssd_scan``).  The dtype flow mirrors the JAX
package: bf16 activations and weights at the point of use, RMSNorm and
RoPE angles in f32, attention scores and the SSM state in f32 with
``-1e30`` masking.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import sharding
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.nn import quantized as nnq
from repro_torch.nn.attention import (decode_attention,
                                      decode_attention_partial,
                                      flash_attention, softcap)
from repro_torch.nn.attention import repeat_kv as _repeat_kv
from repro_torch.nn import xla_numerics as xla

__all__ = ["linear", "rmsnorm", "rope", "softcap", "_repeat_kv",
           "flash_attention", "decode_attention", "paged_decode_attention",
           "paged_prefill_attention", "attention_layer", "ffn_swiglu",
           "moe_route", "moe_layer", "silu", "mamba2_layer"]


# the logical axes of each projection's weight (``lm._*_params`` without
# the leading ``layers``): what a weight provider places under a mesh
AXES = {"wq": ("w_embed", "heads_flat"), "wk": ("w_embed", "kv_flat"),
        "wv": ("w_embed", "kv_flat"), "wo": ("heads_flat", "w_embed"),
        "w_gate": ("w_embed", "mlp"), "w_up": ("w_embed", "mlp"),
        "w_down": ("mlp", "w_embed"),
        "bank_gate": ("experts", "w_embed", None),
        "bank_up": ("experts", "w_embed", None),
        "bank_down": ("experts", None, "w_embed"),
        "in_z": ("w_embed", "ssm_inner"), "in_x": ("w_embed", "ssm_inner"),
        "in_b": ("w_embed", None), "in_c": ("w_embed", None),
        "in_dt": ("w_embed", None), "out_proj": ("ssm_inner", "w_embed")}


def _raw(pp, axes=None, region=None):
    """The weight provider of a layer given none: the weight as it is."""
    return pp["w"]


def _weight(getw, pp, name, region):
    """Projection ``name``'s weight from the provider: ``getw(pp)`` with
    no mesh installed, the reference's ``effective_w(pp)``; under one
    ``getw(pp, AXES[name], region)``, which places this rank's part
    (``models.lm._make_getw``)."""
    if sharding.get_mesh() is None:
        return getw(pp)
    return getw(pp, AXES[name], region)


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """y[..., n] = x[..., k] @ w[k, n]; ``w`` is a dense tensor or a
    :class:`~repro_torch.nn.quantized.PackedLinear` (plan-quantized).
    Operands of two dtypes are promoted first, as ``jnp.einsum`` does
    (the cross attention's bf16 activations against f32 masters)."""
    if isinstance(w, nnq.PackedLinear):
        return w(x)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return xla.matmul(x, w)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            group=None, n: int = 0) -> torch.Tensor:
    """RMSNorm over the last axis.  ``group``: the last axis is split over
    it, ``n`` values in all; the sum of squares is all-reduced
    (``sharding.sum_shared``: every rank goes on with its own part)."""
    dt = x.dtype
    x = x.float()
    if group is None:
        ms = torch.mean(x * x, dim=-1, keepdim=True)
    else:
        ms = sharding.sum_shared(torch.sum(x * x, dim=-1, keepdim=True),
                                 group) / n
    x = x * torch.rsqrt(ms + eps)
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
                    kv_input=None, effective_w=None, tables=None):
    """kind: full | local | chunked | bidir | cross.  mode: train |
    prefill | decode.

    Returns (y, new_cache); train mode takes and returns no cache.  Dense: cache = {"k","v"} of (B, S, Hkv, D);
    prefill returns the prompt's K/V as the new cache, decode writes the
    token's K/V at ``pos`` ((B,) per-slot positions, or one shared ()).
    Paged (``tables`` (B, P) given): cache["k"/"v"] are page pools
    (n_pages + 1, page_size, Hkv, D); decode writes the token's K/V into
    its page, prefill scatters the prompt's K/V into the slot's pages
    (``pos`` then holds the (B,) real prompt lengths; padded rows are
    dropped), and attention reads the pool in place.  Every cache write
    is an in-place ``index_put_`` on the pool tensors -- the JAX package
    got the same effect by donating the cache tree to its jitted step.

    ``bidir`` (the encoder) is full attention without the causal mask.
    ``cross`` takes no rope: train and prefill attend over the keys and
    values of ``kv_input`` (the encoder's output; prefill returns them as
    the new cache), decode over the cached ones (every position).  Under
    a mesh the cross attention is the same region: ``kv_input`` enters
    it as the stream does (the encoder's whole sequence gathered where
    ``act_seq`` splits it), its weights come from the caller's provider
    (raw, placed: ``models.lm._RAW``), and a prefill's cache holds every
    KV head and every encoder position (``lm.cache_logical_axes``'
    ``cross_kv``), from which decode reads its own heads.

    Under a mesh that splits ``heads_flat`` the layer is a
    tensor-parallel region (``sharding.Region``): ``wq`` is split by
    column into this rank's ``h / tp`` query heads, ``wk`` / ``wv`` are
    whole (``kv_flat`` is in no rule) and sliced to the KV heads those
    query heads read, ``wo`` is split by row and its partial output
    leaves the region summed; ``x`` and ``y`` are the stream's rows
    (the sequence split over ``act_seq`` in training and prefill).
    ``effective_w(pp, axes, region)`` gives each weight as this rank
    uses it.  A dense cache is this rank's shard of
    ``lm.cache_logical_axes``: its ``kv_seq`` block of positions (every
    position when ``kv_seq`` is unmapped), every KV head.

    * Prefill: the region's whole-sequence input runs the flash pass on
      the local heads, as in training.  The cache rows are projected
      from this rank's own block of the input rows with the whole ``wk``
      / ``wv``: ``act_seq`` and ``kv_seq`` map to the same axes under the
      reference's prefill rules, so those rows are the ones the rank
      brought into the region, and the cache needs no all-to-all or
      all-gather of K/V (taken over all-gathering the local heads' K/V:
      one extra projection of S / tp rows against a collective of the
      whole sequence's K/V).
    * Decode: the token's K/V (every KV head) is written only by the
      rank whose block holds ``pos``, slot by slot; with ``kv_seq``
      split the local query heads are all-gathered over the heads'
      group, every rank takes the partials of every head over its block
      (``attention.decode_attention_partial``, masked on absolute
      positions), ``sharding.merge_partials`` merges them over the
      ``kv_seq`` group (every rank the same bits), and each rank keeps
      its own heads for the row-split ``wo``.  Under the long-context
      rules (``batch`` unmapped, ``kv_seq`` over every axis) the data
      ranks repeat the projections, as the reference's replicated batch
      does.
    """
    if kind not in ("full", "local", "chunked", "bidir", "cross"):
        raise ValueError(f"unknown attention kind {kind!r}")
    reg = sharding.Region("heads_flat")
    x = reg.enter(x)
    b, s, _ = x.shape
    h, hkv, hd = cfg.h_eff, cfg.hkv_eff, cfg.head_dim
    getw = effective_w or _raw
    # this rank's query heads and the KV heads they read (GQA)
    h, q0 = h // reg.n, reg.i * (h // reg.n)
    g = cfg.h_eff // hkv
    if cfg.h_eff % reg.n or (h % g if h >= g else g % h):
        raise ValueError(f"{cfg.name}: {cfg.h_eff} query heads in groups "
                         f"of {g} over {reg.n} ranks")
    kv0, hkv = q0 // g, max(h // g, 1)
    q = linear(x, _weight(getw, p["wq"], "wq", reg)).reshape(b, s, h, hd)
    q_norm = reg.shared(p["q_norm"]) if cfg.qk_norm else None
    k_norm = reg.shared(p["k_norm"]) if cfg.qk_norm else None
    if cfg.qk_norm:
        q = rmsnorm(q, q_norm, cfg.norm_eps)

    def local_kv(w):
        """The KV heads this rank's query heads read (columns of a
        weight, or dim 2 of K/V)."""
        if hkv == cfg.hkv_eff:
            return w
        if w.dim() == 2:
            return w[:, kv0 * hd:(kv0 + hkv) * hd]
        return w[:, :, kv0:kv0 + hkv]

    def project(rows, w_k, w_v, heads):
        kk = linear(rows, w_k).reshape(b, rows.shape[1], heads, hd)
        vv = linear(rows, w_v).reshape(b, rows.shape[1], heads, hd)
        if cfg.qk_norm:
            kk = rmsnorm(kk, k_norm, cfg.norm_eps)
        return kk, vv

    if kind == "cross":
        if mode == "decode":
            # the encoder's K/V, cached at prefill (every KV head); the
            # step's own projections of the encoder output are never read
            new_cache = cache
            out = decode_attention(q, local_kv(cache["k"]),
                                   local_kv(cache["v"]), None,
                                   cap=cfg.attn_softcap)
        elif mode in ("prefill", "train"):
            # the encoder's whole sequence (this rank's rows of it under
            # a split sequence; its gradient summed back onto them)
            kv_input = reg.enter(kv_input)
            wk, wv = (_weight(getw, p[n], n, reg) for n in ("wk", "wv"))
            if mode == "prefill":
                # the cache holds every KV head on every rank
                # (``cache_logical_axes``); the attention reads its own
                kc, vc = project(kv_input, wk, wv, cfg.hkv_eff)
                kk, vv = local_kv(kc), local_kv(vc)
                new_cache = {"k": kc, "v": vc}
            else:
                kk, vv = project(kv_input, local_kv(wk), local_kv(wv), hkv)
                new_cache = None
            out = flash_attention(q, kk, vv, causal=False,
                                  cap=cfg.attn_softcap)
        else:
            raise ValueError(f"mode must be 'train', 'prefill' or 'decode', "
                             f"got {mode!r}")
        return reg.exit(linear(out.reshape(b, s, h * hd),
                               _weight(getw, p["wo"], "wo", reg))), new_cache
    wk, wv = (_weight(getw, p[n], n, reg) for n in ("wk", "wv"))

    window = cfg.local_window if kind in ("local", "chunked") else 0
    chunked = kind == "chunked"
    dev = x.device
    n_kv = sharding.extent("kv_seq") if tables is None else 1

    if mode == "decode":
        # the token's K/V of every KV head: the cache holds them all
        kk, vv = project(x, wk, wv, cfg.hkv_eff)
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
        elif cache is not None:
            s_loc = cache["k"].shape[1]
            off = sharding.kv_offset(s_loc)
            idx = posn.long().expand(b) - off
            for key, new in (("k", kk), ("v", vv)):
                c, new = cache[key], new[:, 0].to(cache[key].dtype)
                if n_kv > 1:
                    # only the rank whose block holds the slot's
                    # position writes
                    own = ((idx >= 0) & (idx < s_loc))[:, None, None]
                    at = idx.clamp(0, s_loc - 1)
                    c[rows, at] = torch.where(own, new, c[rows, at])
                else:
                    c[rows, idx] = new
            if n_kv > 1:
                qa = sharding.all_gather_cat(q, 2, reg.split)
                m, l, acc = decode_attention_partial(
                    qa, cache["k"], cache["v"], posn, offset=off,
                    window=window, chunked=chunked, cap=cfg.attn_softcap)
                o = sharding.merge_partials(m, l, acc,
                                            sharding.axis_group("kv_seq"))
                out = o[:, None, q0:q0 + h].to(q.dtype)
            else:
                out = decode_attention(q, local_kv(cache["k"]),
                                       local_kv(cache["v"]), posn,
                                       window=window, chunked=chunked,
                                       cap=cfg.attn_softcap)
        else:
            out = decode_attention(q, local_kv(kk), local_kv(vv), posn,
                                   window=window, chunked=chunked,
                                   cap=cfg.attn_softcap)
        new_cache = cache if cache is not None else {"k": kk, "v": vv}
    elif mode in ("prefill", "train"):
        kk, vv = project(x, local_kv(wk), local_kv(wv), hkv)
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
            out = flash_attention(q, kk, vv, causal=kind != "bidir",
                                  window=window, chunked=chunked,
                                  cap=cfg.attn_softcap)
            new_cache = None
            if mode == "prefill" and n_kv == 1 and hkv == cfg.hkv_eff:
                new_cache = {"k": kk, "v": vv}
            elif mode == "prefill":
                # this rank's kv_seq block of positions, every KV head,
                # from its own block of the input rows
                if s % n_kv:
                    raise ValueError(f"a prompt of {s} tokens does not "
                                     f"split over {n_kv} cache blocks")
                s_loc = s // n_kv
                off = sharding.kv_offset(s_loc)
                kc, vc = project(x[:, off:off + s_loc], wk, wv,
                                 cfg.hkv_eff)
                kc = rope(kc, positions[off:off + s_loc], cfg.rope_theta)
                new_cache = {"k": kc, "v": vc}
    else:
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got "
                         f"{mode!r}")

    y = linear(out.reshape(b, s, h * hd), _weight(getw, p["wo"], "wo", reg))
    return reg.exit(y), new_cache


class _Silu(torch.autograd.Function):
    """silu with the JAX package's value and gradient.  The value: the
    logistic written out as ``1 / (1 + exp(-x))``, each op rounded to
    ``x``'s dtype (``jax.nn.silu`` as XLA expands it, which
    ``torch.sigmoid``'s single rounding is not); with ``f32_out`` the
    final product taken in float32 (XLA does not round an elementwise op
    whose result is only converted to float32).  The gradient: JAX's
    product rule and logistic JVP, ``g * s + (g * x) * (s * (1 - s))``
    with each op rounded to ``x``'s dtype and a float32 ``g`` first
    rounded to it (the convert's transpose).  Autograd through the
    written-out logistic rounds other ops: 3.3e-3 relative L2 off JAX's
    gradient in a bf16 SwiGLU FFN's input, every layer of a deep stack
    adding to it."""

    @staticmethod
    def forward(ctx, x, f32_out):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x.float() * s.float() if f32_out else x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        g = g.to(x.dtype)
        return g * s + (g * x) * (s * (1 - s)), None


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` in ``x``'s dtype, value and gradient
    (:class:`_Silu`)."""
    return _Silu.apply(x, False)


def silu_f32(x: torch.Tensor) -> torch.Tensor:
    """``silu(x).astype(float32)`` as the JAX package computes it under
    ``jax.jit``: XLA does not round an elementwise op whose result is only
    converted to float32, so the final product is taken in float32 from
    the rounded logistic."""
    return _Silu.apply(x, True)


class _Gate(torch.autograd.Function):
    """A Mamba-2 layer's gate ``y.astype(g.dtype) * g`` (``g = silu(z)``)
    as the JAX package computes it under ``jax.jit``: the product taken
    in float32 (it only feeds the norm's float32 convert, as in
    :func:`silu_f32`), and JAX's gradient: the float32 cotangent rounded
    to ``g``'s dtype (the convert's transpose), ``y``'s gradient the
    float32 product (it only feeds ``y``'s float32 convert), ``g``'s one
    product in ``g``'s dtype.  Autograd through a float32 product would
    round neither: 3.5e-3 relative L2 off JAX's input gradient of a bf16
    layer."""

    @staticmethod
    def forward(ctx, y, g):
        yr = y.to(g.dtype)
        ctx.save_for_backward(yr, g)
        return yr.float() * g.float()

    @staticmethod
    def backward(ctx, dout):
        yr, g = ctx.saved_tensors
        dout = dout.to(g.dtype)
        return dout.float() * g.float(), dout * yr


_gate = _Gate.apply


def ffn_swiglu(p: dict, x: torch.Tensor, effective_w=None) -> torch.Tensor:
    """SwiGLU; under a mesh that splits ``mlp`` a tensor-parallel region:
    ``w_gate`` / ``w_up`` split by column, ``w_down`` by row."""
    getw = effective_w or _raw
    reg = sharding.Region("mlp")
    x = reg.enter(x)
    g = linear(x, _weight(getw, p["w_gate"], "w_gate", reg))
    u = linear(x, _weight(getw, p["w_up"], "w_up", reg))
    return reg.exit(linear(silu(g) * u,
                           _weight(getw, p["w_down"], "w_down", reg)))


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values, the
    lower index first among equal values (a stable descending sort;
    ``torch.topk`` promises no order for ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(x: torch.Tensor, router_w: torch.Tensor, *, top_k: int,
              capacity: int):
    """The router of ``blocks._moe_local``.  x: (T, D); router_w: (D, E).

    ``x @ router_w`` in the promoted dtype of the two (bf16 activations
    and a float32 router give float32, as JAX promotes; a bf16 router of
    bf16 master weights gives bf16), softmax in that dtype, then
    ``top_k`` experts a token.  Each expert then keeps its
    ``min(capacity, T)`` tokens of largest gate: a token routed
    elsewhere has gate 0 there, so a short expert is filled with
    zero-gate tokens, the lowest indices first (Switch-style dropping).
    Returns ``gates``, ``ids`` (T, top_k) and ``top_g``, ``top_i`` (E,
    C), gates in the logits' dtype.

    Differentiable in the gates, as the reference's ``gate_e = sum(gates
    * (ids == e))`` and ``top_k`` are: ``scatter_`` hands each expert's
    column the gradient of the gates it took, the sorts hand each kept
    value's gradient back to its index, and the router and ``x`` get
    the softmax's."""
    dt = torch.promote_types(x.dtype, router_w.dtype)
    logits = xla.dot_f32(x.to(dt), router_w.to(dt))            # (T, E)
    probs = xla.softmax(logits)
    gates, ids = _top_k(probs, top_k)                           # (T, k)
    gate_e = torch.zeros_like(probs).scatter_(1, ids, gates)    # (T, E)
    top_g, top_i = _top_k(gate_e.T, min(capacity, x.shape[0]))  # (E, C)
    return gates, ids, top_g, top_i


def _moe_local(x, router_w, w_gate, w_up, w_down, *, top_k: int,
               capacity: int, e_offset: int = 0):
    """``blocks._moe_local``: x (T, D) local tokens; banks (E_loc, D, F),
    (E_loc, D, F), (E_loc, F, D) of the local experts ``e_offset ..
    e_offset + E_loc - 1``.  Every token is routed over all E experts
    (``router_w`` (D, E)); each local expert runs its SwiGLU on its ``C``
    routed tokens (one batched product over the local experts), its
    output in float32 is scaled by the gates and added into a float32
    (T, D) sum, which is returned.  A token reaches at most ``top_k``
    experts; with ``top_k`` <= 2 the sum of its terms does not depend on
    their order, so ``index_add_``'s atomic adds on the card give one
    result whatever their order, a remat recompute routes the next MoE
    layer's tokens as the first forward did, and the sum of the ranks'
    partial outputs adds only exact zeros to it.  The gradient reaches
    the banks through the routed tokens' products, the gates through
    ``upd`` and ``x`` through both the gather and the router."""
    _, _, top_g, top_i = moe_route(x, router_w, top_k=top_k,
                                   capacity=capacity)
    e_loc = w_gate.shape[0]
    top_g = top_g[e_offset:e_offset + e_loc]
    top_i = top_i[e_offset:e_offset + e_loc]
    xe = x[top_i]                                               # (E, C, D)
    hh = silu(xla.matmul(xe, w_gate)) * xla.matmul(xe, w_up)
    oe = xla.matmul_f32(hh, w_down)                             # (E, C, D)
    upd = oe * top_g[..., None]
    y = torch.zeros((x.shape[0], x.shape[1]), dtype=upd.dtype,
                    device=x.device)
    y.index_add_(0, top_i.reshape(-1), upd.reshape(-1, x.shape[1]))
    return y


def moe_layer(p: dict, x: torch.Tensor, cfg, effective_w=None):
    """Top-k MoE over ``cfg.n_experts`` (``blocks.moe_layer``).  x: (B, S,
    D), this rank's rows.  The capacity counts every row of them, padded
    and idle rows included: ``max(1, ceil(B * S * k * capacity_factor /
    E))`` -- the reference's ``t_loc``, its tokens a data shard.

    With a mesh installed whose ``experts`` axis is split ``tp > 1`` ways
    (``distributed.sharding``), the banks are this rank's ``E / tp``
    experts (the reference's ``shard_map`` branch), a tensor-parallel
    region (``sharding.Region``): ``x`` enters it (through the copy into
    the expert group, or gathered along the sequence where ``act_seq``
    splits it), the router through the copy, every token is routed over
    all E experts, the local ones run, and the float32 partial sums
    leave it summed before the cast.  The capacity counts a data shard's
    tokens, the whole sequence.  Under a search context the provider
    gives each bank shard the whole bank's Eq. 5 weight
    (``models.lm._make_getw``).  With ``cfg.dense_residual`` the shared
    SwiGLU FFN is added (:func:`ffn_swiglu`, its own region)."""
    getw = effective_w or _raw
    reg = sharding.Region("experts")
    xf = reg.enter(x)
    b, s, dm = xf.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = max(1, int(math.ceil(b * s * k * cfg.capacity_factor / e)))
    e_loc = e // reg.n
    banks = [_weight(getw, p[n], "bank" + n[1:], reg)
             for n in ("w_gate", "w_up", "w_down")]
    if e % reg.n or banks[0].shape[0] != e_loc:
        raise ValueError(f"moe_layer: {e} experts over {reg.n} ranks, the "
                         f"banks hold {banks[0].shape[0]}")
    y = _moe_local(xf.reshape(b * s, dm), reg.shared(p["router"]["w"]),
                   *banks, top_k=k, capacity=cap, e_offset=reg.i * e_loc)
    out = reg.exit(y.reshape(b, s, dm)).to(x.dtype)
    if cfg.dense_residual:
        out = out + ffn_swiglu(p["shared"], x, effective_w)
    return out


# ---------------------------------------------------------------------------
# Mamba-2 SSD mixer
# ---------------------------------------------------------------------------

def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, mode: str,
                   conv_state):
    """Depthwise causal conv.  x: (B, S, C); w: (K, C); ``conv_state``
    (B, K-1, C) is read in decode mode only.  Returns (y, new_conv_state
    (B, K-1, C)).  Prefill sums the K taps one rounded op at a time in
    ``x``'s dtype, the JAX package's order."""
    kk = w.shape[0]
    w = w.to(x.dtype)
    if mode == "decode":
        window = torch.cat([conv_state.to(x.dtype), x], dim=1)   # (B, K, C)
        y = torch.einsum("bkc,kc->bc", window, w)[:, None, :]
        return y, window[:, 1:, :]
    s = x.shape[1]
    pad = torch.zeros((x.shape[0], kk - 1, x.shape[2]), dtype=x.dtype,
                      device=x.device)
    xp = torch.cat([pad, x], dim=1)
    y = xp[:, :s] * xla.broadcast(w[0], xp[:, :s].shape)
    for i in range(1, kk):
        y = y + xp[:, i:i + s] * xla.broadcast(w[i], xp[:, :s].shape)
    return y, xp[:, s:, :]


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus``' value, ``max(x, 0) + log1p(exp(-|x|))``, with
    its gradient ``exp(x - softplus(x))`` (JAX's ``logaddexp`` rule, the
    logistic).  Autograd through the formula would give 1 at x = 0, where
    ``clamp_min`` passes the gradient whole and ``abs`` none, and
    ``dt_bias`` starts at 0.  ``torch.logaddexp(x, 0)`` has JAX's gradient
    but not this value: its exp and log1p round otherwise (not bitwise
    with the formula in float32 or bfloat16 on the CPU)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.exp(x - y)


_softplus = _Softplus.apply


def ssm_chunk(cfg, s: int, mode: str = "prefill") -> int:
    """The chunk length of ``s`` tokens.  Prefill: the largest divisor of
    ``s`` that is at most ``cfg.ssm_chunk`` (a prime prompt length gives
    1), as the JAX package picks it for exact-length serving prefill.
    Train: ``min(cfg.ssm_chunk, s)``, which must tile ``s`` (ValueError
    otherwise), as the JAX package asserts it."""
    q = min(cfg.ssm_chunk, s)
    if mode == "train" and s % q:
        raise ValueError(f"{cfg.name}: training takes sequences that chunk "
                         f"{q} tiles (a multiple of it), got {s} tokens")
    while s % q:
        q -= 1
    return q


def mamba2_layer(p: dict, x: torch.Tensor, cfg, *, mode: str = "prefill",
                 state=None, effective_w=None):
    """Mamba-2 (SSD) mixer.  x: (B, S, D).  mode: train | prefill |
    decode.

    state: {"ssm": (B, H, P, N) f32, "conv": {"x", "b", "c"} of (B, K-1,
    C)}; decode needs it, prefill reads only its ``ssm`` (as the carried
    initial state; None starts from zeros), train none.  Returns (y,
    new_state), new_state None in train mode.  Train runs prefill's
    passes from a zero state at chunk ``min(cfg.ssm_chunk, S)``, which
    must tile S (no divisor search: a shorter chunk would silently change
    the training shapes); every pass is differentiable, K5's through its
    backward kernel.

    Prefill is the chunked SSD dual form in three passes: (a) batched
    over every chunk, the terms that do not depend on the carried state
    -- the intra-chunk output, each chunk's state contribution ``s_in``
    and its decay; (b) the inter-chunk recurrence on kernel K5
    (``kernels/ssd_scan``); (c) each chunk's output from the state before
    it.  The JAX package runs the same recurrence inline, one chunk per
    ``lax.scan`` step.

    Under a mesh that splits ``ssm_inner`` the layer is a
    tensor-parallel region (``sharding.Region``) over ``H / tp`` heads a
    rank: ``in_z``, ``in_x``, ``conv_x``, ``ssm_norm`` and ``out_proj``
    are split, ``in_b``, ``in_c``, ``in_dt``, the B / C conv kernels and
    the per-head vectors whole and used in part (their gradients summed
    over the region; ``in_dt`` and the vectors sliced to the local
    heads), the norm's sum of squares all-reduced over the whole
    ``d_inner``, and K5 (prefill, train) and the one-token recurrence
    (decode) run on the local heads.  ``state`` is then this rank's
    shard of ``lm.cache_logical_axes``: ``ssm`` and ``conv["x"]`` its
    ``ssm_inner`` block, ``conv["b"]`` / ``conv["c"]`` whole; the new
    state comes back so.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got "
                         f"{mode!r}")
    getw = effective_w or _raw
    reg = sharding.Region("ssm_inner")
    x = reg.enter(x)
    b, s, _ = x.shape
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    # this rank's heads and their d_inner channels
    if cfg.ssm_heads % reg.n:
        raise ValueError(f"{cfg.name}: {cfg.ssm_heads} SSM heads over "
                         f"{reg.n} ranks")
    nh = cfg.ssm_heads // reg.n
    di, heads = nh * hd, slice(reg.i * nh, (reg.i + 1) * nh)

    def w(name):
        return _weight(getw, p[name], name, reg)

    z = linear(x, w("in_z"))                                # (B, S, di)
    xs_pre = linear(x, w("in_x"))                           # (B, S, di)
    bb_pre = linear(x, w("in_b"))                           # (B, S, N)
    cc_pre = linear(x, w("in_c"))                           # (B, S, N)
    w_dt = w("in_dt")
    dt = linear(x, w_dt if reg.n == 1 else w_dt[:, heads])  # (B, S, H)

    cst = None if state is None else state["conv"]
    xs_pre, ncx = _causal_conv1d(xs_pre, p["conv_x"], mode,
                                 None if cst is None else cst["x"])
    bb_pre, ncb = _causal_conv1d(bb_pre, reg.shared(p["conv_b"]), mode,
                                 None if cst is None else cst["b"])
    cc_pre, ncc = _causal_conv1d(cc_pre, reg.shared(p["conv_c"]), mode,
                                 None if cst is None else cst["c"])
    new_conv = {"x": ncx, "b": ncb, "c": ncc}
    # the JAX package reshapes xs between silu and the convert, and then
    # XLA keeps the product's rounding (measured, bitwise).  B and C keep
    # it only where the layer is differentiated, where XLA saves them for
    # the backward in their dtype; a forward alone takes their products
    # unrounded (both measured bitwise, bf16)
    xs_f = silu(xs_pre).float().reshape(b, s, nh, hd)       # (B, S, H, P)
    diff = torch.is_grad_enabled() and bb_pre.requires_grad
    bb_f = silu(bb_pre).float() if diff else silu_f32(bb_pre)   # (B, S, N)
    cc_f = silu(cc_pre).float() if diff else silu_f32(cc_pre)   # (B, S, N)
    dt_bias, a_log, d_skip = (reg.shared(p[k])[heads]
                              for k in ("dt_bias", "a_log", "d_skip"))
    dt = _softplus(dt + xla.broadcast(dt_bias, dt.shape)).float()
    a = -torch.exp(a_log.float())                           # (H,)
    dta = dt * a                                            # (B, S, H) <= 0
    d_skip = d_skip.float()[:, None]                        # (H, 1)

    if mode == "decode":
        dec = torch.exp(dta[:, 0])                          # (B, H)
        upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0], xs_f[:, 0],
                           bb_f[:, 0])
        s_new = dec[..., None, None] * state["ssm"] + upd
        y = torch.einsum("bhpn,bn->bhp", s_new, cc_f[:, 0])
        y = (y + d_skip * xs_f[:, 0]).reshape(b, 1, di)
    else:
        q = ssm_chunk(cfg, s, mode)
        nc = s // q
        xs_c = xs_f.reshape(b, nc, q, nh, hd)
        bb_c = bb_f.reshape(b, nc, q, n)
        cc_c = cc_f.reshape(b, nc, q, n)
        dt_c = dt.reshape(b, nc, q, nh)
        # (a) every chunk at once: nothing here reads the carried state
        lcum = torch.cumsum(dta.reshape(b, nc, q, nh), dim=2)   # (B,C,Q,H)
        li = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]    # (B,C,Q,Q,H)
        tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        # masked before the exponential: above the diagonal ``li`` is a
        # positive sum that reaches ~180 over a 256-long chunk, where exp
        # overflows and the backward's 0 * inf would make every gradient
        # NaN.  The same values as the JAX package's where(tri, exp(li),
        # 0), whose gradient is finite only at short chunks.
        decay_qq = torch.exp(torch.where(tri[:, :, None], li, -math.inf))
        scores = torch.einsum("bcqn,bctn->bcqt", cc_c, bb_c)[..., None] \
            * decay_qq                                          # (B,C,Q,Q,H)
        y_intra = torch.einsum("bcqth,bcthp->bcqhp",
                               scores * dt_c[:, :, None], xs_c)
        dec_to_end = torch.exp(lcum[:, :, -1:, :] - lcum)      # (B,C,Q,H)
        s_in = torch.einsum("bcthp,bctn->bchpn",
                            (dec_to_end * dt_c)[..., None] * xs_c, bb_c)
        chunk_decay = torch.exp(lcum[:, :, -1, :])             # (B,C,H)
        # (b) the inter-chunk recurrence, kernel K5 over (C, B*H, P, N)
        s0 = torch.zeros((b, nh, hd, n), dtype=torch.float32,
                         device=x.device) if state is None else \
            state["ssm"].float()
        prefix, final = ssd_ops.ssd_scan(
            chunk_decay.transpose(0, 1).reshape(nc, b * nh).contiguous(),
            s_in.transpose(0, 1).reshape(nc, b * nh, hd, n).contiguous(),
            s0.reshape(b * nh, hd, n).contiguous())
        prefix = prefix.reshape(nc, b, nh, hd, n).transpose(0, 1)
        s_new = final.reshape(b, nh, hd, n)
        # (c) each chunk's output from the state before it
        y_inter = torch.einsum("bchpn,bcqn->bcqhp", prefix, cc_c) \
            * torch.exp(lcum)[..., None]
        y = (y_intra + y_inter).reshape(b, s, nh, hd)
        y = (y + d_skip * xs_f).reshape(b, s, di)

    y = _gate(y, silu(z))
    y = rmsnorm(y, p["ssm_norm"], cfg.norm_eps, reg.split,
                cfg.d_inner).to(x.dtype)
    out = reg.exit(linear(y, w("out_proj")))
    if mode == "train":
        return out, None
    return out, {"ssm": s_new, "conv": new_conv}
