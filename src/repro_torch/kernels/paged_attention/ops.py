"""Dispatch for paged attention, decode (kernel K2,
``csrc/paged_attention.cu``) and prefill (kernel K3,
``csrc/paged_prefill.cu``).

``impl`` resolution, overridable for a block of calls by
:func:`force_impl` (tests and measurement only):

* ``"kernel"`` -- the kernel wrappers :func:`paged_attention_fwd` /
  :func:`paged_prefill_fwd`.  The default for CUDA tensors.  Given CPU
  tensors they run the kernels' plain versions (``ref.py``).
* ``"view"``   -- the gathered dense view plus the dense attention op
  sequence, equal to the dense cache backend.  The default for CPU
  tensors.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import ref as _ref

paged_attention_ref = _ref.paged_attention_ref
paged_attention_view = _ref.paged_attention_view
paged_prefill_ref = _ref.paged_prefill_ref
paged_prefill_view = _ref.paged_prefill_view

# widest q chunk of the prefill kernel's float32 path (and of its plain
# version); the actual chunk is the largest power-of-two divisor of the
# (padded) prompt length up to this.  The bfloat16 path tiles queries
# itself and only validates the chunk.
PREFILL_Q = 16

_IMPLS = ("kernel", "view")
_impl_override: str | None = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def resolve_impl(impl: str | None = None, device=None) -> str:
    if impl is None:
        impl = _impl_override
    if impl is None:
        is_cuda = device is not None and torch.device(device).type == "cuda"
        impl = "kernel" if is_cuda else "view"
    if impl not in _IMPLS:
        raise ValueError(f"unknown paged-attention impl {impl!r} "
                         f"(expected one of {_IMPLS})")
    return impl


@contextlib.contextmanager
def force_impl(impl: str | None):
    """Pin the implementation for every call in the block."""
    global _impl_override
    prev = _impl_override
    _impl_override = resolve_impl(impl) if impl is not None else None
    try:
        yield
    finally:
        _impl_override = prev


@functools.cache
def decode_dims() -> tuple:
    """The head dims the decode kernel is built for, as
    ``csrc/paged_attention.cu`` lists them (builds it)."""
    out = (ctypes.c_int * 8)()
    n = build.symbol("paged_attention", "paged_decode_dims")(out)
    return tuple(out[:n])


@functools.cache
def decode_split_tokens(d: int, dtype: int) -> int:
    """Logical tokens one split of the decode kernel covers at head dim
    ``d`` (dtype code 0 = float32, 1 = bfloat16); raises for a head dim
    the kernel is not built for."""
    n = build.symbol("paged_attention", "paged_decode_split_tokens")(d, dtype)
    if n <= 0:
        raise ValueError(f"paged decode supports head dims {decode_dims()}, "
                         f"got D={d}")
    return n


@functools.cache
def prefill_bf16_dims() -> tuple:
    """The head dims the prefill kernel's bfloat16 (tensor-core) path is
    built for, as ``csrc/paged_prefill.cu`` lists them (builds it)."""
    out = (ctypes.c_int * 8)()
    n = build.symbol("paged_prefill", "paged_prefill_bf16_dims")(out)
    return tuple(out[:n])


def prefill_q_chunk(s: int) -> int:
    """Largest power-of-two q-chunk width up to :data:`PREFILL_Q` that
    tiles a length-``s`` prompt."""
    return math.gcd(s, PREFILL_Q)


def _check(q, k_pool, v_pool, tables, q_heads_dim: int):
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4:
        raise ValueError(f"pools must share one (n_pages + 1, page_size, "
                         f"Hkv, D) shape, got {tuple(k_pool.shape)} and "
                         f"{tuple(v_pool.shape)}")
    h, d = q.shape[q_heads_dim], q.shape[-1]
    hkv = k_pool.shape[2]
    if d != k_pool.shape[3] or h % hkv:
        raise ValueError(f"q heads/dim ({h}, {d}) do not fit pools with "
                         f"Hkv={hkv}, D={k_pool.shape[3]}")
    if tables.dim() != 2 or tables.shape[0] != q.shape[0]:
        raise ValueError(f"tables must be (B, P), got {tuple(tables.shape)}")


def _cuda_args(q, k_pool, v_pool, tables, *ints):
    """Validate CUDA operands; return (dtype code, table row stride)."""
    dev = q.device
    if any(t.device != dev for t in (k_pool, v_pool, tables, *ints)):
        raise ValueError("paged attention operands are on different devices")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q and pools must share float32 or bfloat16, got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if any(t.dtype != torch.int32 for t in (tables, *ints)):
        raise TypeError("tables / positions must be int32")
    if not (q.is_contiguous() and k_pool.is_contiguous()
            and v_pool.is_contiguous()
            and all(t.is_contiguous() for t in ints)):
        raise ValueError("q, pools and positions must be contiguous")
    if tables.shape[1] > 1 and tables.stride(1) != 1:
        raise ValueError("table rows must be contiguous")
    return _DTYPES[q.dtype], tables.stride(0)


def paged_attention_fwd(q, k_pool, v_pool, tables, pos, *, window: int = 0,
                        chunked: bool = False, cap: float = 0.0):
    """Decode attention over the page pool (kernel K2).  q: (B, H, D);
    k_pool/v_pool: (n_pages + 1, page_size, Hkv, D), page 0 the null
    page; tables: (B, P) int32 physical page ids (0 = unbacked; a view of
    wider tables is fine); pos: (B,) int32.  Returns (B, H, D) in q's
    dtype.

    On the card the key range of each slot is split over blocks
    (flash-decoding) whose partial softmax states a second kernel
    merges; it needs D in :func:`decode_dims` and q and pools that start
    on a 16-byte boundary.  The partials go to f32 scratch of B * H *
    splits * (D + 2) floats, splits = ceil(P * page_size /
    :func:`decode_split_tokens`)."""
    _check(q, k_pool, v_pool, tables, 1)
    if q.device.type == "cpu":
        return _ref.paged_attention_ref(q, k_pool, v_pool, tables, pos,
                                        window=window, chunked=chunked,
                                        cap=cap)
    dtype, tstride = _cuda_args(q, k_pool, v_pool, tables, pos)
    b, h, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    split = decode_split_tokens(d, dtype)
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged decode needs q and pools that start on a "
                         "16-byte boundary")
    p = tables.shape[1]
    splits = max(1, -(-p * ps // split))
    out = torch.empty_like(q)
    scratch = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                          device=q.device)
    fn = build.load("paged_attention")
    build.check(fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                   tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
                   scratch.data_ptr(), scratch.numel(), b, h, hkv, d, ps, p,
                   tstride, int(window), int(bool(chunked)), float(cap),
                   1.0 / math.sqrt(d), dtype,
                   torch.cuda.current_stream(q.device).cuda_stream),
                "paged_attention")
    paged_attention_fwd.launches += 1
    return out


paged_attention_fwd.launches = 0


def paged_prefill_fwd(q, k_pool, v_pool, tables, lens, *, window: int = 0,
                      chunked: bool = False, cap: float = 0.0,
                      q_chunk: int = PREFILL_Q):
    """Prefill attention over the page pool (kernel K3).  q: (B, S, H, D)
    with S a multiple of ``q_chunk`` (padded rows give garbage the
    caller drops); pools and tables as for decode; lens: (B,) real
    prompt lengths, accepted and unused (masking is by position).
    Returns (B, S, H, D) in q's dtype.

    On the card the dtype picks the kernel: float32 runs on the CUDA
    cores in q chunks of ``q_chunk``; bfloat16 runs on the tensor cores
    with its own query tiling (``q_chunk`` is only validated) and needs
    D in :func:`prefill_bf16_dims` and 16-byte aligned q and pools."""
    _check(q, k_pool, v_pool, tables, 2)
    b, s, h, d = q.shape
    q_chunk = min(q_chunk, s)
    if s % q_chunk:
        raise ValueError(f"S={s} is not a multiple of q_chunk={q_chunk}")
    if q.device.type == "cpu":
        return _ref.paged_prefill_ref(q, k_pool, v_pool, tables, lens,
                                      window=window, chunked=chunked,
                                      cap=cap, q_chunk=q_chunk)
    dtype, tstride = _cuda_args(q, k_pool, v_pool, tables)
    if q.dtype == torch.bfloat16:
        dims = prefill_bf16_dims()
        if d not in dims:
            raise ValueError(f"bfloat16 paged prefill supports head dims "
                             f"{dims}, got D={d}")
        if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
            raise ValueError("bfloat16 paged prefill needs q and pools "
                             "that start on a 16-byte boundary")
    _, ps, hkv, _ = k_pool.shape
    out = torch.empty_like(q)
    fn = build.load("paged_prefill")
    build.check(fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                   tables.data_ptr(), out.data_ptr(), b, s, h, hkv, d, ps,
                   tables.shape[1], tstride, q_chunk, int(window),
                   int(bool(chunked)), float(cap), 1.0 / math.sqrt(d),
                   dtype, torch.cuda.current_stream(q.device).cuda_stream),
                "paged_prefill")
    paged_prefill_fwd.launches += 1
    return out


paged_prefill_fwd.launches = 0


def paged_attention(q, k_pool, v_pool, tables, pos, *, window: int = 0,
                    chunked: bool = False, cap: float = 0.0,
                    impl: str | None = None):
    """Decode attention over the page pool; see :func:`resolve_impl`."""
    fn = _ref.paged_attention_view \
        if resolve_impl(impl, q.device) == "view" else paged_attention_fwd
    return fn(q, k_pool, v_pool, tables, pos, window=window,
              chunked=chunked, cap=cap)


def paged_prefill_attention(q, k_pool, v_pool, tables, lens, *,
                            window: int = 0, chunked: bool = False,
                            cap: float = 0.0, impl: str | None = None):
    """Prefill attention over the page pool; see :func:`resolve_impl`."""
    if resolve_impl(impl, q.device) == "view":
        return _ref.paged_prefill_view(q, k_pool, v_pool, tables, lens,
                                       window=window, chunked=chunked,
                                       cap=cap)
    return paged_prefill_fwd(q, k_pool, v_pool, tables, lens, window=window,
                             chunked=chunked, cap=cap,
                             q_chunk=prefill_q_chunk(q.shape[1]))
