"""The LM of ``repro.models.lm``, dense and pure-SSM (Mamba-2) families.

Parameters are a nested dict of tensors with the JAX package's tree and
shapes: each super-block's weights are stacked ``(n_superblocks, ...)``
under ``params["blocks"]["l<i>"]``.  A tree bound to a plan
(``serve.engine.apply_plan``) holds ``blocks`` as a tuple of per-super-
block trees instead, with :class:`~repro_torch.nn.quantized.PackedLinear`
weights.  Either way the forward is a Python loop over super-blocks;
caches keep the stacked ``(nsb, ...)`` layout and are updated in place.

MoE, hybrid, enc-dec and frontend architectures raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.nn import blocks
from repro_torch.nn import quantized as nnq

_FAMILY_ITEM = {
    "moe": "ROADMAP slice C1 (MoE)",
    "hybrid": "ROADMAP slice C1 (MoE; its Mamba-2 layers are ported)",
    "encdec": "ROADMAP slice C3 (enc-dec and VLM)",
    "vlm": "ROADMAP slice C3 (enc-dec and VLM)",
}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str           # attn | attn_local | attn_chunked | mamba
    ffn: Optional[str]   # dense | None


def _require_ported(cfg: ArchConfig):
    dense = cfg.family == "dense" and not cfg.ssm_state
    ssm = cfg.family == "ssm" and cfg.is_ssm
    if (not (dense or ssm) or cfg.is_moe or cfg.is_encdec
            or cfg.frontend != "none"):
        item = _FAMILY_ITEM.get(cfg.family, "ROADMAP slice C")
        raise NotImplementedError(
            f"{cfg.name} (family={cfg.family}) is not ported yet; it comes "
            f"with {item}")


def block_pattern(cfg: ArchConfig) -> tuple[LayerSpec, ...]:
    """Decoder super-block pattern; n_layers % len(pattern) == 0."""
    _require_ported(cfg)
    if cfg.is_ssm:
        return (LayerSpec("mamba", None),)
    if cfg.attn_pattern == "local_global":
        return (LayerSpec("attn_local", "dense"), LayerSpec("attn", "dense"))
    if cfg.attn_pattern == "chunked":
        return (LayerSpec("attn_chunked", "dense"),) * 3 + \
            (LayerSpec("attn", "dense"),)
    return (LayerSpec("attn", "dense"),)


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


def _plan_weights(cfg: ArchConfig):
    """``(layer, sub, name)`` of every plan-servable projection, in the
    JAX package's order (its ``_walk_plan_weights`` walks a template tree
    whose dict keys JAX sorts)."""
    out = []
    for i, spec in enumerate(block_pattern(cfg)):
        if spec.mixer == "mamba":
            out += [(f"l{i}", "mixer", n) for n in _MAMBA_PROJ]
        else:
            out += [(f"l{i}", "mixer", n) for n in ("wq", "wk", "wv", "wo")]
        if spec.ffn is not None:
            out += [(f"l{i}", "ffn", n)
                    for n in ("w_gate", "w_up", "w_down")]
    return sorted(out)


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """Random parameters with ``lm.init_params``' tree and shapes (not its
    numbers: ``jax.random`` and ``torch.Generator`` differ), drawn on
    ``device`` (default ``cuda``) from ``generator`` (default seed 0)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = torch.float32 if cfg.param_dtype == "float32" \
        else torch.bfloat16
    nsb = n_superblocks(cfg)
    d, v = cfg.d_model, padded_vocab(cfg)
    h, hkv, hd = cfg.h_eff, cfg.hkv_eff, cfg.head_dim

    def w(shape, scale=None, stack=True):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        full = ((nsb,) if stack else ()) + shape
        return {"w": torch.randn(full, generator=generator, device=dev,
                                 dtype=torch.float32).to(dtype) * scale}

    def vec(shape, init=0.0, stack=True):
        full = ((nsb,) if stack else ()) + shape
        return torch.full(full, init, dtype=dtype, device=dev)

    params = {"embed": w((v, d), scale=0.02, stack=False)}
    blk = {}
    for i, spec in enumerate(block_pattern(cfg)):
        if spec.mixer == "mamba":
            blk[f"l{i}"] = {"norm1": vec((d,)),
                            "mixer": _mamba_params(cfg, w, vec)}
            continue
        mixer = {"wq": w((d, h * hd)), "wk": w((d, hkv * hd)),
                 "wv": w((d, hkv * hd)), "wo": w((h * hd, d))}
        if cfg.qk_norm:
            mixer["q_norm"] = vec((hd,))
            mixer["k_norm"] = vec((hd,))
        blk[f"l{i}"] = {
            "norm1": vec((d,)), "mixer": mixer, "norm2": vec((d,)),
            "ffn": {"w_gate": w((d, cfg.d_ff)), "w_up": w((d, cfg.d_ff)),
                    "w_down": w((cfg.d_ff, d))}}
    params["blocks"] = blk
    params["final_norm"] = vec((d,), stack=False)
    params["lm_head"] = w((d, v), scale=0.02, stack=False)
    return params


def _mamba_params(cfg: ArchConfig, w, vec) -> dict:
    """``lm._mamba_params``' tree: five input projections, the output
    projection, three depthwise conv kernels and the per-head vectors."""
    d, di, n, h, kk = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_heads, cfg.ssm_conv)
    return {"in_z": w((d, di)), "in_x": w((d, di)), "in_b": w((d, n)),
            "in_c": w((d, n)), "in_dt": w((d, h)), "out_proj": w((di, d)),
            "conv_x": vec((kk, di), 0.1), "conv_b": vec((kk, n), 0.1),
            "conv_c": vec((kk, n), 0.1), "dt_bias": vec((h,)),
            "a_log": vec((h,)), "d_skip": vec((h,), 1.0),
            "ssm_norm": vec((di,))}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _getw(pp):
    """Weight provider: dense weights cast to bf16 at the point of use; a
    :class:`PackedLinear` goes through untouched."""
    w = pp["w"]
    if isinstance(w, nnq.PackedLinear):
        return w
    return w.to(torch.bfloat16)


def _index(tree, j: int):
    if isinstance(tree, dict):
        return {k: _index(v, j) for k, v in tree.items()}
    return tree[j]


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


def _embed_in(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    # gather rows first, cast after: the same values as casting the table
    x = params["embed"]["w"][tokens.long()].to(torch.bfloat16)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.bfloat16,
                            device=x.device)


def forward(cfg: ArchConfig, params, batch, *, mode: str = "prefill",
            caches=None, pos=None, logits_mode: str = "full",
            last_pos=None, tables=None):
    """Returns (logits | hidden, caches).

    batch: {"tokens": (B, S) int}.  mode: prefill | decode.  logits_mode:
    "full" | "last" (one position: S-1, or ``last_pos``, a () tensor) |
    "hidden".  tables: (B, P) int32 block tables when ``caches`` holds
    page pools (see :func:`init_paged_caches`); for a paged prefill
    ``pos`` holds the (B,) real prompt lengths.  Caches passed in are
    updated in place and returned; a dense prefill returns new stacked
    caches: ``(nsb, B, S, Hkv, D)`` KV, and for a Mamba-2 layer its SSM
    state ``(nsb, B, H, P, N)`` and conv windows ``(nsb, B, K-1, C)``.
    A prefill given caches starts each Mamba-2 layer from their SSM
    state, as the JAX package does.
    """
    pattern = block_pattern(cfg)
    kinds = {"attn": "full", "attn_local": "local",
             "attn_chunked": "chunked"}
    x = _embed_in(cfg, params, batch["tokens"])
    # ``s`` is the f32 residual sum ``x`` was rounded from.  An RMSNorm
    # after a residual add reads ``s``, not ``x``: XLA fuses the add into
    # the norm without rounding it, and the JAX package's tokens follow
    # that.  Only the stacked tree's super-block boundary rounds (JAX
    # carries ``x`` through a lax.scan there); a plan-bound tree is one
    # unrolled graph.  The residual stream itself stays bf16.
    s = x
    per_sb = params["blocks"]
    stacked = not isinstance(per_sb, (list, tuple))
    nsb = n_superblocks(cfg)
    out_caches = []
    for j in range(nsb):
        blk = _index(per_sb, j) if stacked else per_sb[j]
        if stacked:
            s = x
        new = {}
        for i, spec in enumerate(pattern):
            p = blk[f"l{i}"]
            hn = blocks.rmsnorm(s, p["norm1"], cfg.norm_eps).to(x.dtype)
            if spec.mixer == "mamba":
                st = None if caches is None else \
                    _index(caches[f"l{i}"]["mamba"], j)
                y, st_new = blocks.mamba2_layer(
                    p["mixer"], hn, cfg, mode=mode, state=st,
                    effective_w=_getw)
                if st is not None:
                    _store(st, st_new)
                new[f"l{i}"] = {"mamba": st_new}
            else:
                kv = None if caches is None else \
                    _index(caches[f"l{i}"]["kv"], j)
                y, kv_new = blocks.attention_layer(
                    p["mixer"], hn, cfg, kind=kinds[spec.mixer], mode=mode,
                    cache=kv, pos=pos, effective_w=_getw, tables=tables)
                new[f"l{i}"] = {"kv": kv_new}
            s = x.float() + y.float()
            x = s.to(x.dtype)
            if spec.ffn is None:
                continue
            h2 = blocks.rmsnorm(s, p["norm2"], cfg.norm_eps).to(x.dtype)
            s = x.float() + blocks.ffn_swiglu(p["ffn"], h2,
                                              effective_w=_getw).float()
            x = s.to(x.dtype)
        out_caches.append(new)
    if caches is None:
        caches = _stack(out_caches)
    if stacked:
        s = x
    x = blocks.rmsnorm(s, params["final_norm"], cfg.norm_eps).to(x.dtype)
    if logits_mode == "hidden":
        return x, caches
    if logits_mode == "last":
        if last_pos is None:
            x = x[:, -1:, :]
        else:
            idx = torch.as_tensor(last_pos, device=x.device).reshape(1)
            x = x.index_select(1, idx.long())
    logits = torch.matmul(x, params["lm_head"]["w"].to(torch.bfloat16))
    if cfg.final_softcap > 0:
        logits = blocks.softcap(logits, cfg.final_softcap)
    return logits, caches


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


def _cache_tree(cfg: ArchConfig, batch: int, kv_shape: tuple, dev):
    nsb = n_superblocks(cfg)
    return {f"l{i}": {"mamba": _mamba_state(cfg, nsb, batch, dev)}
            if spec.mixer == "mamba" else {"kv": {
                k: torch.zeros((nsb,) + kv_shape, dtype=torch.bfloat16,
                               device=dev) for k in ("k", "v")}}
            for i, spec in enumerate(block_pattern(cfg))}


def init_caches(cfg: ArchConfig, batch: int, seq_len: int, device=None):
    """Dense caches stacked ``(n_superblocks, batch, ...)`` per pattern
    slot: bf16 KV ``(nsb, batch, seq_len, Hkv, D)`` for an attention
    layer, the per-slot state of :func:`_mamba_state` for a Mamba-2
    one."""
    return _cache_tree(cfg, batch,
                       (batch, seq_len, cfg.hkv_eff, cfg.head_dim),
                       resolve_device(device))


def init_paged_caches(cfg: ArchConfig, batch: int, page_size: int,
                      n_pages: int, device=None):
    """Paged KV pools ``(nsb, n_pages + 1, page_size, Hkv, D)`` per
    attention slot, bf16 zeros; physical page 0 is the reserved null page.
    SSM state is O(1) per request and keeps the dense per-slot layout
    ``(nsb, batch, ...)``."""
    return _cache_tree(cfg, batch,
                       (n_pages + 1, page_size, cfg.hkv_eff, cfg.head_dim),
                       resolve_device(device))


def _n_layers(cfg: ArchConfig, mamba: bool) -> int:
    pat = block_pattern(cfg)
    return n_superblocks(cfg) * sum((s.mixer == "mamba") == mamba
                                    for s in pat)


def kv_bytes_per_token(cfg: ArchConfig) -> int:
    """Bytes of KV cache one token position pins across all attention
    layers (0 for pure-SSM architectures)."""
    return 2 * _n_layers(cfg, False) * cfg.hkv_eff * cfg.head_dim * 2


def ssm_bytes_per_slot(cfg: ArchConfig) -> int:
    """Bytes of recurrent (SSM + conv) state one decode slot pins (0 for
    attention-only architectures)."""
    per_layer = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4 + \
        (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * 2
    return _n_layers(cfg, True) * per_layer


def dense_cache_bytes(cfg: ArchConfig, batch: int, seq_len: int) -> int:
    """Total bytes :func:`init_caches` pins for a dense decode pool."""
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
        w = params["blocks"][ln][sub][name]["w"]          # (nsb, K, N)
        for j in range(w.shape[0]):
            out[f"blocks.{ln}.{sub}.{name}.sb{j}"] = w[j].T
    return out
