"""The LM of ``repro.models.lm``: the dense, MoE, pure-SSM (Mamba-2),
encoder-decoder and VLM families.

Parameters are a nested dict of tensors with the JAX package's tree and
shapes: each super-block's weights are stacked ``(n_superblocks, ...)``
under ``params["blocks"]["l<i>"]``; with ``mps_on`` every block
projection also carries its per-output-channel selection logits
``gamma (n_superblocks, C_out, |P_W|)`` (the paper's joint search on the
LM track: ``loss_fn`` with a ``SearchCtx``, ``mps_size_cost``,
``extract_plan``).  An MoE layer's ``ffn`` holds a ``router`` (D, E) and
the expert banks ``w_gate`` / ``w_up`` (nsb, E, D, F) and ``w_down``
(nsb, E, F, D), plus the dense ``shared`` FFN with
``cfg.dense_residual``.  An enc-dec decoder layer adds ``norm_cross`` and
a ``cross`` attention set; the encoder is ``enc_blocks`` (bidirectional
attention + dense FFN, stacked over its own ``enc_layers`` super-blocks)
and ``enc_norm``.  A batch may carry a stub frontend's ``embeddings``
(B, S, D) in place of ``tokens``, and for enc-dec ``enc_embeddings``.
The hybrid (jamba) mixes the families in one super-block: Mamba-2 and
attention mixers, each layer followed by a dense or an MoE FFN.
A tree bound to a plan (``serve.engine.apply_plan``) holds ``blocks`` as
a tuple of per-super-block trees instead, with
:class:`~repro_torch.nn.quantized.PackedLinear` weights; ``enc_blocks``
stays stacked and float.  Either way the forward is a Python loop over
super-blocks; caches keep the stacked ``(nsb, ...)`` layout and are
updated in place.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import mps, sampling
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.nn import blocks
from repro_torch.nn import quantized as nnq
from repro_torch.nn import xla_numerics

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str       # attn | attn_local | attn_chunked | attn_bidir | mamba
    ffn: Optional[str]   # dense | moe | None
    cross: bool = False


def block_pattern(cfg: ArchConfig) -> tuple[LayerSpec, ...]:
    """Decoder super-block pattern; n_layers % len(pattern) == 0."""
    if cfg.is_hybrid:  # jamba: 1:7 attn:mamba, MoE every other layer
        return tuple(LayerSpec("attn" if i == cfg.attn_every // 2
                               else "mamba", "moe" if i % 2 else "dense")
                     for i in range(cfg.attn_every))
    if cfg.is_ssm:
        return (LayerSpec("mamba", None),)
    if cfg.attn_pattern == "local_global":
        return (LayerSpec("attn_local", "dense"), LayerSpec("attn", "dense"))
    ffn = "moe" if cfg.is_moe else "dense"
    if cfg.attn_pattern == "chunked":
        return (LayerSpec("attn_chunked", ffn),) * 3 + (LayerSpec("attn",
                                                                  ffn),)
    if cfg.is_moe and cfg.moe_every > 1:
        return tuple(LayerSpec("attn", "moe" if i % cfg.moe_every ==
                               cfg.moe_every - 1 else "dense")
                     for i in range(cfg.moe_every))
    return (LayerSpec("attn", ffn, cross=cfg.is_encdec),)


def enc_pattern(cfg: ArchConfig) -> tuple[LayerSpec, ...]:
    """The encoder's super-block pattern (enc-dec only)."""
    return (LayerSpec("attn_bidir", "dense"),)


def n_enc_superblocks(cfg: ArchConfig) -> int:
    return cfg.enc_layers // len(enc_pattern(cfg))


def n_superblocks(cfg: ArchConfig) -> int:
    pat = block_pattern(cfg)
    if cfg.n_layers % len(pat):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not tile "
                         f"into super-blocks of {len(pat)}")
    return cfg.n_layers // len(pat)


def padded_vocab(cfg: ArchConfig) -> int:
    return -(-cfg.vocab // 256) * 256


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

_MAMBA_PROJ = ("in_b", "in_c", "in_dt", "in_x", "in_z", "out_proj")
_ATTN_PROJ = ("wq", "wk", "wv", "wo")
_FFN_PROJ = ("w_gate", "w_up", "w_down")


def _plan_weights(cfg: ArchConfig):
    """``(layer, sub, name)`` of every plan-servable projection, in the
    JAX package's order (its ``_walk_plan_weights`` walks a template tree
    whose dict keys JAX sorts).  ``name`` is dotted below ``sub`` for an
    MoE layer's shared FFN (``shared.w_down``); its router and 4-D expert
    banks are no plan groups.  An enc-dec decoder layer's ``cross``
    projections are plan groups; the encoder's are not (``blocks`` only,
    as the reference walks)."""
    out = []
    for i, spec in enumerate(block_pattern(cfg)):
        if spec.mixer == "mamba":
            out += [(f"l{i}", "mixer", n) for n in _MAMBA_PROJ]
        else:
            out += [(f"l{i}", "mixer", n) for n in _ATTN_PROJ]
        if spec.cross:
            out += [(f"l{i}", "cross", n) for n in _ATTN_PROJ]
        if spec.ffn == "dense":
            out += [(f"l{i}", "ffn", n) for n in _FFN_PROJ]
        elif spec.ffn == "moe" and cfg.dense_residual:
            out += [(f"l{i}", "ffn", f"shared.{n}") for n in _FFN_PROJ]
    return sorted(out)


def _node(tree: dict, dotted: str):
    for k in dotted.split("."):
        tree = tree[k]
    return tree


class _Leaf:
    """A tensor and its logical axes, while :func:`_build` walks the
    tree (split apart by :func:`_split`)."""
    __slots__ = ("t", "axes")

    def __init__(self, t, axes):
        self.t, self.axes = t, tuple(axes)


def _split(tree):
    if isinstance(tree, dict):
        parts = {k: _split(v) for k, v in tree.items()}
        return ({k: v[0] for k, v in parts.items()},
                {k: v[1] for k, v in parts.items()})
    return tree.t, tree.axes


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device=None, mps_on: bool = False) -> dict:
    """Random parameters with ``lm.init_params``' tree and shapes (not its
    numbers: ``jax.random`` and ``torch.Generator`` differ), drawn on
    ``device`` (default ``cuda``) from ``generator`` (default seed 0).
    ``mps_on`` gives every block projection (the encoder's and the cross
    attention's too) its float32 selection logits ``gamma (nsb, C_out,
    |P_W|)`` at the paper's Eq. 13 init (the reference's values);
    ``embed`` and ``lm_head`` carry none.  On the ``meta`` device the tree
    has its shapes and no numbers (no generator)."""
    return _build(cfg, generator, device, mps_on)[0]


def logical_axes(cfg: ArchConfig, mps_on: bool = False) -> dict:
    """``lm.logical_axes``: the tree of :func:`init_params` with each leaf
    its tuple of logical axis names (``distributed.sharding``), built by
    the same walk on the ``meta`` device.  A stacked leaf leads with
    ``"layers"``; an expert bank is ``("experts", "w_embed", None)`` (its
    ``w_down`` ``("experts", None, "w_embed")``); a gamma ``(None,
    None)``."""
    return _build(cfg, None, "meta", mps_on)[1]


def _build(cfg: ArchConfig, generator, device, mps_on: bool):
    """(parameters, logical axes) of :func:`init_params` and
    :func:`logical_axes`, one walk."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = torch.float32 if cfg.param_dtype == "float32" \
        else torch.bfloat16
    nsb = n_superblocks(cfg)
    d, v = cfg.d_model, padded_vocab(cfg)

    def w(shape, logical, scale=None, n=nsb, gamma=True):
        """A weight stacked over ``n`` super-blocks (``n=0``: unstacked)."""
        fan_in = shape[0] if len(shape) == 2 else shape[-2]
        scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        full = ((n,) if n else ()) + shape
        lead = ("layers",) if n else ()
        if len(shape) == 3 and dev.type != "meta":
            # an expert bank (nsb, E, K, N): drawn one expert at a time,
            # so no float32 copy of the whole bank is ever made
            arr = torch.empty(full, dtype=dtype, device=dev)
            for j in range(n):
                for e in range(shape[0]):
                    arr[j, e] = torch.randn(
                        shape[1:], generator=generator, device=dev,
                        dtype=torch.float32).to(dtype) * scale
        else:
            arr = torch.randn(full, generator=generator, device=dev,
                              dtype=torch.float32).to(dtype) * scale
        out = {"w": _Leaf(arr, lead + tuple(logical))}
        if mps_on and n and gamma:
            out["gamma"] = _Leaf(sampling.init_selection_logits(
                cfg.mps_precisions, (n, shape[-1]), dev), lead + (None, None))
        return out

    def vec(shape, logical, init=0.0, n=nsb):
        full = ((n,) if n else ()) + shape
        return _Leaf(torch.full(full, init, dtype=dtype, device=dev),
                     (("layers",) if n else ()) + tuple(logical))

    params = {"embed": w((v, d), ("vocab", "w_embed"), scale=0.02, n=0)}
    params["blocks"] = {f"l{i}": _layer_params(cfg, spec, w, vec, nsb)
                        for i, spec in enumerate(block_pattern(cfg))}
    params["final_norm"] = vec((d,), (None,), n=0)
    params["lm_head"] = w((d, v), ("w_embed", "vocab"), scale=0.02, n=0)
    if cfg.is_encdec:
        ne = n_enc_superblocks(cfg)
        params["enc_blocks"] = {f"l{i}": _layer_params(cfg, spec, w, vec, ne)
                                for i, spec in enumerate(enc_pattern(cfg))}
        params["enc_norm"] = vec((d,), (None,), n=0)
    return _split(params)


def _layer_params(cfg: ArchConfig, spec: LayerSpec, w, vec, n: int) -> dict:
    """``lm._layer_params``: one pattern slot stacked over ``n``
    super-blocks."""
    w, vec = functools.partial(w, n=n), functools.partial(vec, n=n)
    d = cfg.d_model
    p = {"norm1": vec((d,), (None,)),
         "mixer": _mamba_params(cfg, w, vec) if spec.mixer == "mamba"
         else _attn_params(cfg, w, vec)}
    if spec.cross:
        p["norm_cross"] = vec((d,), (None,))
        p["cross"] = _attn_params(cfg, w, vec)
    if spec.ffn is not None:
        p["norm2"] = vec((d,), (None,))
        p["ffn"] = _moe_params(cfg, w) if spec.ffn == "moe" \
            else _ffn_params(cfg, w)
    return p


def _attn_params(cfg: ArchConfig, w, vec) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.h_eff, cfg.hkv_eff, cfg.head_dim
    ax = blocks.AXES
    p = {"wq": w((d, h * hd), ax["wq"]), "wk": w((d, hkv * hd), ax["wk"]),
         "wv": w((d, hkv * hd), ax["wv"]), "wo": w((h * hd, d), ax["wo"])}
    if cfg.qk_norm:
        p["q_norm"] = vec((hd,), (None,))
        p["k_norm"] = vec((hd,), (None,))
    return p


def _ffn_params(cfg: ArchConfig, w) -> dict:
    d, f, ax = cfg.d_model, cfg.d_ff, blocks.AXES
    return {"w_gate": w((d, f), ax["w_gate"]), "w_up": w((d, f), ax["w_up"]),
            "w_down": w((f, d), ax["w_down"])}


def _moe_params(cfg: ArchConfig, w) -> dict:
    """``lm._moe_params``' tree: the router (no gamma), the expert banks
    and, with ``dense_residual``, the shared FFN.  Under ``mps_on`` each
    bank carries the reference's one gamma ``(nsb, C_out, |P_W|)``, shared
    by all its experts."""
    d, e, f, ax = cfg.d_model, cfg.n_experts, cfg.expert_d_ff, blocks.AXES
    out = {"router": w((d, e), (None, None), gamma=False),
           "w_gate": w((e, d, f), ax["bank_gate"]),
           "w_up": w((e, d, f), ax["bank_up"]),
           "w_down": w((e, f, d), ax["bank_down"])}
    if cfg.dense_residual:
        out["shared"] = _ffn_params(cfg, w)
    return out


def _mamba_params(cfg: ArchConfig, w, vec) -> dict:
    """``lm._mamba_params``' tree: five input projections, the output
    projection, three depthwise conv kernels and the per-head vectors."""
    d, di, n, h, kk = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_heads, cfg.ssm_conv)
    ax = blocks.AXES
    return {"in_z": w((d, di), ax["in_z"]), "in_x": w((d, di), ax["in_x"]),
            "in_b": w((d, n), ax["in_b"]), "in_c": w((d, n), ax["in_c"]),
            "in_dt": w((d, h), ax["in_dt"]),
            "out_proj": w((di, d), ax["out_proj"]),
            "conv_x": vec((kk, di), (None, "ssm_inner"), 0.1),
            "conv_b": vec((kk, n), (None, None), 0.1),
            "conv_c": vec((kk, n), (None, None), 0.1),
            "dt_bias": vec((h,), (None,)), "a_log": vec((h,), (None,)),
            "d_skip": vec((h,), (None,), 1.0),
            "ssm_norm": vec((di,), ("ssm_inner",))}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _make_getw(cfg: ArchConfig, ctx: Optional[mps.SearchCtx]):
    """Weight provider (``lm._make_effective_w``): ``getw(pp, axes,
    region)`` gives the weight of node ``pp`` as this rank computes with
    it.  A :class:`PackedLinear` goes through untouched; under a
    ``SearchCtx`` a weight with a gamma becomes its Eq. 5 effective
    weight (``core.mps.effective_weight``, kernel K4 on the card, its
    output channels on the last axis); every dense weight is cast to
    bf16 at the point of use.

    Under a mesh, ``axes`` (the weight's logical axes, ``blocks.AXES``)
    say how the rank's shard is cut.  Eq. 5 runs on the shard where the
    master lies, with the whole weight's per-channel absmax (all-reduced
    over the mesh axes that split its C_in) and this shard's rows of the
    selection probabilities (their gradient summed over the split axes
    other than the data axes, which the step's average sums); then the
    bf16 cast; a weight the tensor-parallel ``region``
    (``sharding.Region``) does not split enters through the copy into
    it (each rank uses it for its own part); then the FSDP all-gather of
    every dimension split over the data axes, whose backward
    reduce-scatters the gradient (the sum over the data ranks).  The
    all-gather moves bf16, as the reference's does."""

    def getw(pp, axes=None, region=None):
        w = pp["w"]
        if isinstance(w, nnq.PackedLinear):
            return w
        dims = sharding.dim_axes(*axes) if axes is not None else []
        if dims and len(dims) != w.dim():
            raise ValueError(f"logical axes {axes} for a weight of shape "
                             f"{tuple(w.shape)}")
        if not any(dims):
            dims = []
        if ctx is None or "gamma" not in pp:
            out = w.to(torch.bfloat16)
        else:
            out = _effective(cfg, ctx, w, pp["gamma"], dims)
        if region is not None and not region.splits(dims):
            out = region.shared(out)
        if not dims:
            return out
        batch = set(sharding.mesh_axes("batch"))
        for d, ax in enumerate(dims):
            if ax and set(ax) <= batch:
                out = sharding.gather(out, d, sharding.group_of(ax))
        return out
    return getw


def _effective(cfg, ctx, w, gamma, dims):
    """Eq. 5 of a weight (or a rank's shard: ``dims`` its dimensions'
    mesh axes, ``sharding.dim_axes``), cast to bf16."""
    ch = w.dim() - 1
    if not dims:
        return mps.effective_weight(w.float(), gamma, cfg.mps_precisions,
                                    ctx, channel_axis=ch).to(torch.bfloat16)
    cin = {a for ax in dims[:ch] for a in ax}
    batch = set(sharding.mesh_axes("batch"))
    split = {a for ax in dims for a in ax} - batch
    rows = None
    if dims[ch]:
        n = w.shape[ch]
        rows = (sharding.get_mesh().index(dims[ch]) * n, n)
    return mps.effective_weight(
        w.float(), gamma, cfg.mps_precisions, ctx, channel_axis=ch,
        absmax_group=sharding.group_of(tuple(cin)),
        probs_group=sharding.group_of(tuple(split)),
        rows=rows).to(torch.bfloat16)


def _index(tree, j: int):
    if isinstance(tree, dict):
        return {k: _index(v, j) for k, v in tree.items()}
    return tree[j]


def _unstack(tree, n: int) -> list:
    """The ``n`` per-super-block trees of a stacked tree, each leaf one
    ``torch.unbind`` view: the backward stacks the n gradients once,
    where indexing ``leaf[j]`` n times would scatter each into a zero
    tensor of the whole stack and sum n of them."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][j] for k in tree} for j in range(n)]
    return torch.unbind(tree)


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _store(dst, src):
    """Copy a state tree into the cache slice ``dst`` in place."""
    if isinstance(dst, dict):
        for k in dst:
            _store(dst[k], src[k])
    else:
        dst.copy_(src)


def _embed_in(cfg, params, batch) -> torch.Tensor:
    """The decoder's input: a stub frontend's ``embeddings`` cast to bf16
    (no scale), else the embedding rows of ``tokens`` times sqrt(d).

    Under a mesh the table ``(vocab, w_embed)`` is this rank's shard: it
    is gathered over the data axes (FSDP, float32: the rows' gradient is
    summed in float32 as on one device), each rank looks up the tokens
    of its vocab rows (Megatron's vocab-parallel embedding), and the
    rows are summed over the vocab group onto the stream's layout
    (reduce-scattered along a split sequence): one rank's row plus exact
    zeros, the single device's values."""
    if "embeddings" in batch:
        return batch["embeddings"].to(torch.bfloat16)
    table, tokens = params["embed"]["w"], batch["tokens"].long()
    dims = sharding.dim_axes("vocab", "w_embed")
    if dims and dims[1]:
        table = sharding.gather(table, 1, sharding.group_of(dims[1]))
    reg = sharding.Region("vocab")
    if reg.n > 1:
        local = tokens - reg.i * table.shape[0]
        hit = (local >= 0) & (local < table.shape[0])
        x = table[local.clamp(0, table.shape[0] - 1)] * hit[..., None]
    else:
        # gather rows first, cast after: the same values as casting the
        # table
        x = table[tokens]
    x = reg.exit(x).to(torch.bfloat16)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.bfloat16,
                            device=x.device)


_KINDS = {"attn": "full", "attn_local": "local", "attn_chunked": "chunked",
          "attn_bidir": "bidir"}


def _superblock(cfg: ArchConfig, pattern, blk, x, s, *, mode, caches, j,
                pos, getw, tables, enc_out):
    """One super-block's layers.  ``x`` is the residual stream, ``s`` the
    f32 sum it was rounded from (see :func:`forward`).  Returns (x, s,
    the block's new caches).

    The stream is bf16, except after a float tree's cross attention: its
    projections take the raw weights (the reference passes the cross
    branch no weight hook), f32 masters give f32 products, and JAX
    promotes ``x + yc`` and everything after it in the layer to f32.
    Under a mesh that splits ``act_seq`` the stream holds this rank's
    rows of the sequence: the norms run on them (their weights' gradients
    summed over the sequence's group) and each mixer and FFN is a
    tensor-parallel region between them."""
    new = {}
    for i, spec in enumerate(pattern):
        p = blk[f"l{i}"]
        c = None if caches is None else caches.get(f"l{i}")
        nc = new[f"l{i}"] = {}
        hn = blocks.rmsnorm(s, sharding.seq_shared(p["norm1"]),
                            cfg.norm_eps).to(x.dtype)
        if spec.mixer == "mamba":
            st = None if c is None else _index(c["mamba"], j)
            y, st_new = blocks.mamba2_layer(
                p["mixer"], hn, cfg, mode=mode, state=st, effective_w=getw)
            if st is not None:
                _store(st, st_new)
            nc["mamba"] = st_new
        else:
            kv = None if c is None else _index(c["kv"], j)
            y, nc["kv"] = blocks.attention_layer(
                p["mixer"], hn, cfg, kind=_KINDS[spec.mixer], mode=mode,
                cache=kv, pos=pos, effective_w=getw, tables=tables)
        s = x.float() + y.float()
        x = s.to(x.dtype)
        if spec.cross and (enc_out is not None or mode == "decode"):
            hc = blocks.rmsnorm(s, p["norm_cross"], cfg.norm_eps).to(x.dtype)
            ckv = None if c is None else _index(c["cross_kv"], j)
            yc, nc["cross_kv"] = blocks.attention_layer(
                p["cross"], hc, cfg, kind="cross", mode=mode, cache=ckv,
                kv_input=enc_out)
            s = x.float() + yc.float()
            x = s.to(torch.promote_types(x.dtype, yc.dtype))
        if spec.ffn is None:
            continue
        h2 = blocks.rmsnorm(s, sharding.seq_shared(p["norm2"]),
                            cfg.norm_eps).to(x.dtype)
        if spec.ffn == "moe":
            y2 = blocks.moe_layer(p["ffn"], h2, cfg, effective_w=getw)
        else:
            y2 = blocks.ffn_swiglu(p["ffn"], h2, effective_w=getw)
        s = x.float() + y2.float()
        x = s.to(x.dtype)
    return x, s, new


def _run_stack(cfg: ArchConfig, pattern, per_sb, n: int, x, *, mode,
               caches, pos, getw, tables, enc_out, remat: bool):
    """Every super-block in order (``lm._run_stack`` / its unrolled
    twin).  ``per_sb`` is a stacked tree of ``n`` super-blocks or a tuple
    of per-super-block trees (plan-bound).  Returns (x, s, the per-block
    new caches)."""
    stacked = not isinstance(per_sb, (list, tuple))
    if stacked:
        per_sb = _unstack(per_sb, n)
    s = x
    out_caches = []
    for j in range(n):
        blk = per_sb[j]
        kw = dict(mode=mode, caches=caches, j=j, pos=pos, getw=getw,
                  tables=tables, enc_out=enc_out)
        if remat and stacked:
            x = checkpoint(lambda xj, blk=blk, kw=kw: _superblock(
                cfg, pattern, blk, xj, xj, **kw)[0].to(xj.dtype), x,
                use_reentrant=False)
            continue
        if stacked:
            s = x
        in_dtype = x.dtype
        x, s, new = _superblock(cfg, pattern, blk, x, s, **kw)
        if stacked:
            # the reference carries x through a lax.scan: the super-block
            # boundary rounds it back to the carry's dtype
            x = x.to(in_dtype)
        out_caches.append(new)
    if stacked:
        s = x
    return x, s, out_caches


def _encode(cfg: ArchConfig, params, batch, getw, remat: bool):
    """The encoder (``lm._encode``): ``enc_embeddings`` cast to bf16, or
    else :func:`_embed_in` of the batch (the decoder's ``embeddings`` when
    the batch holds them, else its tokens), through the stacked
    ``enc_blocks`` in train mode, then ``enc_norm``."""
    if "enc_embeddings" in batch:
        xe = batch["enc_embeddings"].to(torch.bfloat16)
    else:
        xe = _embed_in(cfg, params, batch)
    xe, s, _ = _run_stack(cfg, enc_pattern(cfg), params["enc_blocks"],
                          n_enc_superblocks(cfg), xe, mode="train",
                          caches=None, pos=None, getw=getw, tables=None,
                          enc_out=None, remat=remat)
    return blocks.rmsnorm(s, params["enc_norm"], cfg.norm_eps).to(xe.dtype)


def forward(cfg: ArchConfig, params, batch, *, mode: str = "prefill",
            caches=None, pos=None, logits_mode: str = "full",
            last_pos=None, tables=None, ctx: Optional[mps.SearchCtx] = None):
    """Returns (logits | hidden, caches).

    batch: {"tokens": (B, S) int} or a stub frontend's {"embeddings": (B,
    S, D)}; for enc-dec optionally "enc_embeddings" (B, S_enc, D), else
    the encoder embeds the decoder's input.  mode: train | prefill |
    decode; train takes and returns no caches and, with ``cfg.remat``,
    recomputes each super-block in the backward
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``),
    every family's stack, MoE and hybrid ones included: an expert bank
    ``(E, K, C_out)`` under a ``SearchCtx`` is one Eq. 5 weight against
    its one gamma, each channel's absmax taken over all ``E * K`` of its
    values (on the card K4 over ``C_out`` rows of ``E * K``).
    ctx: a ``SearchCtx`` turns every weight with a gamma into its
    effective weight (the cross attention's excepted, as in the
    reference).  logits_mode: "full" | "last" (one position: S-1, or
    ``last_pos``, a () tensor) | "hidden".  tables: (B, P) int32 block
    tables when ``caches`` holds page pools (see
    :func:`init_paged_caches`); for a paged prefill ``pos`` holds the (B,)
    real prompt lengths.  Caches passed in are updated in place and
    returned; a dense prefill returns new stacked caches: ``(nsb, B, S,
    Hkv, D)`` KV, for a cross layer its ``cross_kv`` ``(nsb, B, S_enc,
    Hkv, D)`` in the projections' dtype, and for a Mamba-2 layer its SSM
    state ``(nsb, B, H, P, N)`` and conv windows ``(nsb, B, K-1, C)``.
    Under a mesh that splits a tensor-parallel, sequence or FSDP axis
    (``sharding.tp_split``) only the training step of the dense, SSM and
    MoE families is placed: ``mode="train"`` with ``logits_mode="hidden"``
    gives this rank's rows of the batch, the whole sequence (gathered
    once after the final norm); anything else raises a ValueError naming
    ROADMAP section 1, items 2-3.
    A prefill given caches starts each Mamba-2 layer from their SSM
    state, as the JAX package does; a Mamba-2 layer the given tree lacks
    (a hybrid's paged prefill is handed only its KV pools) starts from
    zero, and its new state is returned in the tree.  Any other missing
    layer raises.

    An enc-dec decode step reads the encoder's K/V from ``cross_kv`` and
    does not run the encoder: the reference runs it over the step's one
    token and uses none of its output.
    """
    if sharding.tp_split():
        if mode != "train" or logits_mode != "hidden":
            sharding.refuse_split(f"lm.forward(mode={mode!r}, "
                                  f"logits_mode={logits_mode!r})")
        if cfg.family not in ("dense", "ssm", "moe"):
            sharding.refuse_split(f"the {cfg.family} family's training "
                                  f"step")
    pattern = block_pattern(cfg)
    missing = [] if caches is None else [
        f"l{i}" for i in range(len(pattern)) if f"l{i}" not in caches]
    if any(pattern[int(ln[1:])].mixer != "mamba" for ln in missing):
        raise ValueError(f"{cfg.name}: the cache tree lacks {missing}; only "
                         f"a Mamba-2 layer may be left out (it then starts "
                         f"from zero)")
    getw = _make_getw(cfg, ctx)
    remat = mode == "train" and cfg.remat
    enc_out = None
    if cfg.is_encdec and mode != "decode":
        enc_out = _encode(cfg, params, batch, getw, remat)
    # ``s`` is the f32 residual sum ``x`` was rounded from.  An RMSNorm
    # after a residual add reads ``s``, not ``x``: XLA fuses the add into
    # the norm without rounding it, and the JAX package's tokens follow
    # that.  Only the stacked tree's super-block boundary rounds (JAX
    # carries ``x`` through a lax.scan there); a plan-bound tree is one
    # unrolled graph.  The residual stream itself stays bf16.
    x, s, out_caches = _run_stack(
        cfg, pattern, params["blocks"], n_superblocks(cfg),
        _embed_in(cfg, params, batch), mode=mode, caches=caches, pos=pos,
        getw=getw, tables=tables, enc_out=enc_out, remat=remat)
    if mode == "train":
        caches = None
    elif caches is None:
        caches = _stack(out_caches)
    elif missing:
        # a hybrid's paged prefill is handed the KV pools alone (the
        # cache's ``kv_caches``): its Mamba-2 layers start from zero
        # and their new (nsb, B, ...) states come back beside the pools
        caches = {**caches, **_stack([{ln: blk[ln] for ln in missing}
                                      for blk in out_caches])}
    x = blocks.rmsnorm(s, sharding.seq_shared(params["final_norm"]),
                       cfg.norm_eps).to(x.dtype)
    if logits_mode == "hidden":
        return sharding.seq_gather(x), caches
    if logits_mode == "last":
        if last_pos is None:
            x = x[:, -1:, :]
        else:
            idx = torch.as_tensor(last_pos, device=x.device).reshape(1)
            x = x.index_select(1, idx.long())
    logits = xla_numerics.matmul(x, params["lm_head"]["w"].to(
        torch.bfloat16))
    if cfg.final_softcap > 0:
        logits = blocks.softcap(logits, cfg.final_softcap)
    return logits, caches


LOSS_SEQ_CHUNKS = 8


def loss_fn(cfg: ArchConfig, params, batch,
            ctx: Optional[mps.SearchCtx] = None, lam: float = 0.0,
            logical=None) -> torch.Tensor:
    """Mean next-token cross-entropy (+ ``lam * mps_size_cost`` under a
    ``SearchCtx``).  The logits are formed over ``LOSS_SEQ_CHUNKS``
    sequence chunks, each recomputed in the backward, so the f32 (B, S, V)
    logits never exist at once; the chunk sums are added in order, as the
    reference does.

    Under a mesh the head ``(w_embed, vocab)`` is gathered over the data
    axes (FSDP, bf16) and keeps this rank's vocab columns: the
    cross entropy is vocab-parallel (Megatron's): the logsumexp from the
    group's MAX and its sum of exponentials, the target's logit from the
    rank that holds it, every rank ending with the same loss.  ``logical``
    (the tree's logical axes) goes to :func:`mps_size_cost`."""
    hidden, _ = forward(cfg, params, batch, mode="train", ctx=ctx,
                        logits_mode="hidden")
    targets = batch["targets"].long()
    head = params["lm_head"]["w"].to(torch.bfloat16)
    dims = sharding.dim_axes("w_embed", "vocab")
    if dims and dims[0]:
        head = sharding.gather(head, 0, sharding.group_of(dims[0]))
    vg = sharding.group_of(dims[1]) if dims else None
    v_loc = head.shape[1]
    lo = sharding.get_mesh().index(dims[1]) * v_loc if vg is not None else 0

    def chunk_nll(x_c, tgt_c):
        logits = torch.matmul(x_c, head)
        if cfg.final_softcap > 0:
            logits = blocks.softcap(logits, cfg.final_softcap)
        logits = logits.float()
        if vg is None:
            logz = torch.logsumexp(logits, dim=-1)
            tgt = torch.take_along_dim(logits, tgt_c[..., None],
                                       dim=-1)[..., 0]
            return torch.sum(logz - tgt)
        m = sharding.all_reduce_max(logits.detach().amax(dim=-1), vg)
        se = sharding.reduce_from(torch.sum(torch.exp(
            logits - m[..., None]), dim=-1), vg)
        logz = m + torch.log(se)
        local = tgt_c - lo
        hit = (local >= 0) & (local < v_loc)
        tgt = torch.take_along_dim(logits, local.clamp(0, v_loc - 1)[
            ..., None], dim=-1)[..., 0] * hit
        return torch.sum(logz - sharding.reduce_from(tgt, vg))

    b, s, _ = hidden.shape
    nc = LOSS_SEQ_CHUNKS if s % LOSS_SEQ_CHUNKS == 0 else 1
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(nc):
        sl = slice(i * (s // nc), (i + 1) * (s // nc))
        total = total + checkpoint(chunk_nll, hidden[:, sl], targets[:, sl],
                                   use_reentrant=False)
    task = total / float(b * s)
    if ctx is not None and lam > 0.0:
        task = task + lam * mps_size_cost(cfg, params, ctx, logical)
    return task


def _gamma_nodes(tree, axes=None):
    """Every ``{"w", "gamma", ...}`` node, in the reference's order; with
    ``axes`` (the tree's logical axes) each beside its weight's axes."""
    if not isinstance(tree, dict):
        return
    if "w" in tree and "gamma" in tree:
        yield tree if axes is None else (tree, axes["w"])
        return
    for k in sorted(tree):
        yield from _gamma_nodes(tree[k], None if axes is None else axes[k])


def mps_size_cost(cfg: ArchConfig, params, ctx: mps.SearchCtx,
                  logical=None) -> torch.Tensor:
    """Differentiable expected size in bytes over every gamma-carrying
    weight (paper Eq. 9 with C_in fixed per super-block: the residual
    stream keeps d_model; pruning shows through the 0-bit channels).  C_in
    is the whole weight's, whether the tree holds it or a rank's shard
    (under a mesh each split dimension counts whole); an expert bank's is
    ``E * K`` with E all ``cfg.n_experts``: its one gamma prices every
    expert's copy of a channel.  The gammas are whole on every rank.
    ``logical``, the tree's logical axes, is read under a mesh only (built
    there when not given)."""
    mesh = sharding.get_mesh()
    if mesh is None:
        nodes = ((node, None) for node in _gamma_nodes(params))
    else:
        nodes = _gamma_nodes(params, logical or logical_axes(cfg, True))
    total = None
    for node, axes in nodes:
        w, gm = node["w"], node["gamma"]
        shape = list(w.shape)
        if mesh is not None:
            for d, ax in enumerate(sharding.dim_axes(*axes)):
                shape[d] *= mesh.size(ax)
        elif w.dim() - gm.dim() + 2 == 3:      # an expert bank (E, K, C)
            shape[-3] = cfg.n_experts
        cin = math.prod(shape[:-1])
        if gm.dim() == 3:          # stacked over super-blocks
            cin //= gm.shape[0]
        eb = mps.expected_bits(gm, cfg.mps_precisions, ctx)
        term = torch.sum(eb) * cin / 8.0
        total = term if total is None else total + term
    if total is None:
        raise ValueError("mps_size_cost needs parameters with gammas "
                         "(init_params(..., mps_on=True))")
    return total


def mps_param_count(cfg: ArchConfig) -> int:
    """Number of gamma-carrying weight matrices (stacked over super-blocks,
    so one per projection of the pattern), counted in ``init_params``'
    tree on the meta device."""
    tree = init_params(cfg, device="meta", mps_on=True)
    return sum(1 for _ in _gamma_nodes(tree))


def decode_step(cfg: ArchConfig, params, token_batch, caches, pos,
                tables=None):
    """One-token decode.  token_batch: {"tokens": (B, 1)}; pos: () shared
    or (B,) per-slot positions; tables: (B, P) int32 when ``caches``
    holds page pools.  Returns (logits (B, 1, V), caches)."""
    return forward(cfg, params, token_batch, mode="decode", caches=caches,
                   pos=pos, tables=tables)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _mamba_state(cfg: ArchConfig, nsb: int, batch: int, dev) -> dict:
    """Per-slot Mamba-2 state: f32 SSM state (nsb, batch, H, P, N) and
    bf16 conv windows (nsb, batch, K-1, C), zeros."""
    def mk(*shape, dtype=torch.bfloat16):
        return torch.zeros((nsb, batch) + shape, dtype=dtype, device=dev)
    k1 = cfg.ssm_conv - 1
    return {"ssm": mk(cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                      dtype=torch.float32),
            "conv": {"x": mk(k1, cfg.d_inner), "b": mk(k1, cfg.ssm_state),
                     "c": mk(k1, cfg.ssm_state)}}


def _cache_tree(cfg: ArchConfig, batch: int, kv_shape: tuple, dev,
                enc_len: int = 0):
    nsb = n_superblocks(cfg)

    def kv(shape):
        return {k: torch.zeros((nsb,) + shape, dtype=torch.bfloat16,
                               device=dev) for k in ("k", "v")}

    out = {}
    for i, spec in enumerate(block_pattern(cfg)):
        c = {"mamba": _mamba_state(cfg, nsb, batch, dev)} \
            if spec.mixer == "mamba" else {"kv": kv(kv_shape)}
        if spec.cross:
            c["cross_kv"] = kv((batch, enc_len, cfg.hkv_eff, cfg.head_dim))
        out[f"l{i}"] = c
    return out


def init_caches(cfg: ArchConfig, batch: int, seq_len: int, enc_len: int = 0,
                device=None):
    """Dense caches stacked ``(n_superblocks, batch, ...)`` per pattern
    slot: bf16 KV ``(nsb, batch, seq_len, Hkv, D)`` for an attention
    layer, the per-slot state of :func:`_mamba_state` for a Mamba-2 one,
    and for an enc-dec cross layer bf16 ``cross_kv`` ``(nsb, batch,
    enc_len, Hkv, D)``."""
    return _cache_tree(cfg, batch,
                       (batch, seq_len, cfg.hkv_eff, cfg.head_dim),
                       resolve_device(device), enc_len)


def cache_logical_axes(cfg: ArchConfig) -> dict:
    """``lm.cache_logical_axes``: the logical axes of :func:`init_caches`'
    tree."""
    caches = {}
    for i, spec in enumerate(block_pattern(cfg)):
        c = {}
        if spec.mixer == "mamba":
            c["mamba"] = {
                "ssm": ("layers", "batch", "ssm_inner", None, None),
                "conv": {"x": ("layers", "batch", None, "ssm_inner"),
                         "b": ("layers", "batch", None, None),
                         "c": ("layers", "batch", None, None)}}
        else:
            c["kv"] = {"k": ("layers", "batch", "kv_seq", None, None),
                       "v": ("layers", "batch", "kv_seq", None, None)}
        if spec.cross:
            c["cross_kv"] = {
                "k": ("layers", "batch", None, None, None),
                "v": ("layers", "batch", None, None, None)}
        caches[f"l{i}"] = c
    return caches


def init_paged_caches(cfg: ArchConfig, batch: int, page_size: int,
                      n_pages: int, device=None):
    """Paged KV pools ``(nsb, n_pages + 1, page_size, Hkv, D)`` per
    attention slot, bf16 zeros; physical page 0 is the reserved null page.
    SSM state is O(1) per request and keeps the dense per-slot layout
    ``(nsb, batch, ...)``.  Decoder-only: an enc-dec stack raises, as in
    the reference."""
    if cfg.is_encdec:
        raise NotImplementedError("paged caches are decoder-only")
    return _cache_tree(cfg, batch,
                       (n_pages + 1, page_size, cfg.hkv_eff, cfg.head_dim),
                       resolve_device(device))


def _n_layers(cfg: ArchConfig, mamba: bool) -> int:
    pat = block_pattern(cfg)
    return n_superblocks(cfg) * sum((s.mixer == "mamba") == mamba
                                    for s in pat)


def kv_bytes_per_token(cfg: ArchConfig) -> int:
    """Bytes of KV cache one token position pins across all attention
    layers (0 for pure-SSM architectures; an enc-dec stack's self
    attention only, as the reference counts)."""
    return 2 * _n_layers(cfg, False) * cfg.hkv_eff * cfg.head_dim * 2


def ssm_bytes_per_slot(cfg: ArchConfig) -> int:
    """Bytes of recurrent (SSM + conv) state one decode slot pins (0 for
    attention-only architectures)."""
    per_layer = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4 + \
        (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * 2
    return _n_layers(cfg, True) * per_layer


def dense_cache_bytes(cfg: ArchConfig, batch: int, seq_len: int) -> int:
    """Total bytes :func:`init_caches` pins for a dense decode pool (with
    ``enc_len`` 0, as the reference counts)."""
    return (kv_bytes_per_token(cfg) * seq_len + ssm_bytes_per_slot(cfg)) \
        * batch


# ---------------------------------------------------------------------------
# CompressionPlan groups
# ---------------------------------------------------------------------------

def serve_weight_groups(cfg: ArchConfig, params) -> dict:
    """Plan-group name (``blocks.l0.mixer.wq.sb3``, ...) -> ``(C_out,
    C_in)`` float matrix for every quantizable projection, in the JAX
    package's order."""
    out = {}
    for ln, sub, name in _plan_weights(cfg):
        w = _node(params["blocks"][ln][sub], name)["w"]   # (nsb, K, N)
        for j in range(w.shape[0]):
            out[f"blocks.{ln}.{sub}.{name}.sb{j}"] = w[j].T
    return out


def extract_plan(cfg: ArchConfig, params, px=(8,), meta=None):
    """Discretize an LM's selection logits into a
    :class:`~repro_torch.api.plan.CompressionPlan` (paper Eq. 7/8 on the
    LM track): per super-block, each output channel takes
    ``pw[argmax gamma]``, under the :func:`serve_weight_groups` names.
    ``params`` must carry gammas (``init_params(mps_on=True)``, e.g.
    after a ``make_train_step(search=True)`` run)."""
    from repro_torch.api.plan import CompressionPlan

    pw = np.asarray(cfg.mps_precisions)
    gamma = {}
    for ln, sub, name in _plan_weights(cfg):
        node = _node(params["blocks"][ln][sub], name)
        if "gamma" not in node:
            raise KeyError(f"blocks.{ln}.{sub}.{name} carries no gamma; "
                           f"extract_plan needs init_params(mps_on=True)")
        g = node["gamma"].detach().float().cpu().numpy()  # (nsb, C, |P|)
        bits = pw[np.argmax(g, axis=-1)]                  # (nsb, C)
        for j in range(bits.shape[0]):
            gamma[f"blocks.{ln}.{sub}.{name}.sb{j}"] = bits[j]
    assignment = {"gamma": gamma, "delta": {}, "alpha": {}}
    base = {"track": "lm", "arch": cfg.name}
    return CompressionPlan.from_assignment(
        assignment, cfg.mps_precisions, px, meta={**base, **(meta or {})})
