"""``mps_combine``: the search's effective weight (paper Eq. 5, kernel
K4, ``csrc/mps_combine.cu``) with the reference's straight-through
gradient.

``mps_combine`` is a ``torch.autograd.Function``.  The scale is
``max(absmax, 1e-8) * (1 / qmax)`` with the float32 reciprocal, as the
reference computes it under ``jax.jit`` (``core.quantizers.recip``).  Its
forward is :func:`mps_combine_fwd`, its backward :func:`mps_combine_bwd`:
each launches its kernel for a CUDA tensor and runs its plain version for
a CPU one -- the forward ``ref.py``, the backward :func:`_vjp_bwd`, the
JAX package's ``_vjp_bwd`` (``repro/kernels/mps_combine/ops.py``) in
plain torch ops, the scale held constant::

    dW[i, k]       = g[i, k] * sum_p probs[i, p] * (1{|r| < qmax_p}
                                                 + 0.5 * 1{|r| = qmax_p})
    dprobs[i, p]   = sum_k g[i, k] * Q_p(W)[i, k]

The forward kernel also writes each row's absmax, which the backward
kernel reads instead of reducing W again.  Or the forward takes each
row's absmax as given (``absmax_in``), as the TPU kernel does: an expert
bank split over ranks combines its rows against the per-channel maximum
over every rank's rows (``core.mps.effective_weight(..., group=)``).
"""
from __future__ import annotations

import torch

from repro_torch.core import quantizers
from repro_torch.kernels import build
from repro_torch.kernels.mps_combine import ref as _ref

mps_combine_ref = _ref.mps_combine_ref

MAX_PRECISIONS = 8


def _check(w, probs, precisions):
    if w.dim() != 2 or probs.dim() != 2 or probs.shape != (
            w.shape[0], len(precisions)):
        raise ValueError(f"mps_combine takes w (M, K) and probs (M, |P|), "
                         f"got {tuple(w.shape)}, {tuple(probs.shape)} for "
                         f"{len(precisions)} precisions")
    if not 1 <= len(precisions) <= MAX_PRECISIONS or any(
            b != 0 and not 2 <= b <= 16 for b in precisions):
        raise ValueError(f"mps_combine takes 1..{MAX_PRECISIONS} "
                         f"precisions of 0 or 2..16 bits, got {precisions}")


def _packed(precisions) -> int:
    return sum(int(b) << (8 * i) for i, b in enumerate(precisions))


def _on_card(what, *ts):
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{what} runs on one cuda device or the cpu, got "
                         f"tensors on {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{what} takes float32 tensors, got "
                        f"{[t.dtype for t in ts]}")


def mps_combine_fwd(w: torch.Tensor, probs: torch.Tensor,
                    precisions: tuple[int, ...],
                    absmax: torch.Tensor | None = None,
                    absmax_in: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 5 forward (kernel K4).  w: (M, K) f32; probs: (M, |P|) f32.
    Returns (M, K) f32; fills ``absmax`` (M,) f32 with each row's
    ``max |w|`` when given.  ``absmax_in`` (M,) f32, contiguous, gives
    each row's absmax instead (the kernels do not reduce the rows; any
    value at least the row's own ``max |w|``); it excludes ``absmax``."""
    _check(w, probs, precisions)
    for name, t in (("absmax", absmax), ("absmax_in", absmax_in)):
        if t is not None and t.shape != (w.shape[0],):
            raise ValueError(f"{name} must be ({w.shape[0]},), got "
                             f"{tuple(t.shape)}")
    if absmax is not None and absmax_in is not None:
        raise ValueError("mps_combine_fwd takes absmax (written) or "
                         "absmax_in (read), not both")
    if w.device.type == "cpu":
        if absmax_in is not None:
            if absmax_in.device.type != "cpu" or absmax_in.dtype != w.dtype:
                raise ValueError(f"absmax_in must be a {w.dtype} cpu tensor "
                                 f"beside w, got {absmax_in.dtype} on "
                                 f"{absmax_in.device}")
            return _ref.mps_combine_ref(w, probs, precisions, absmax_in)
        if absmax is not None:
            absmax.copy_(torch.amax(w.abs(), dim=1))
        return _ref.mps_combine_ref(w, probs, precisions)
    extra = [t for t in (absmax, absmax_in) if t is not None]
    _on_card("mps_combine", w, probs, *extra)
    w = w.contiguous()
    probs = probs.contiguous()
    if any(not t.is_contiguous() for t in extra):
        raise ValueError("absmax / absmax_in must be contiguous")
    out = torch.empty_like(w)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    if absmax_in is not None:
        fn = build.symbol("mps_combine", "mps_combine_given_launch")
        rc = fn(w.data_ptr(), probs.data_ptr(), absmax_in.data_ptr(),
                out.data_ptr(), w.shape[0], w.shape[1], len(precisions),
                _packed(precisions), stream)
    else:
        fn = build.load("mps_combine")
        rc = fn(w.data_ptr(), probs.data_ptr(), out.data_ptr(),
                0 if absmax is None else absmax.data_ptr(),
                w.shape[0], w.shape[1], len(precisions),
                _packed(precisions), stream)
    build.check(rc, "mps_combine")
    mps_combine_fwd.launches += 1
    mps_combine_fwd.given_launches += absmax_in is not None
    return out


# every launch; of them, the launches given an absmax
mps_combine_fwd.launches = 0
mps_combine_fwd.given_launches = 0


def mps_combine_bwd(w: torch.Tensor, probs: torch.Tensor,
                    absmax: torch.Tensor, g: torch.Tensor,
                    precisions: tuple[int, ...]):
    """The straight-through backward of :func:`mps_combine`: ``(dw,
    dprobs)`` for the upstream gradient ``g`` (M, K), given the forward's
    per-row ``absmax`` (M,), which both the kernel and the plain version
    read."""
    _check(w, probs, precisions)
    if g.shape != w.shape or absmax.shape != (w.shape[0],):
        raise ValueError(f"mps_combine_bwd takes g {tuple(w.shape)} and "
                         f"absmax ({w.shape[0]},), got {tuple(g.shape)}, "
                         f"{tuple(absmax.shape)}")
    if w.device.type == "cpu":
        return _vjp_bwd(w, probs, precisions, g, absmax)
    _on_card("mps_combine_bwd", w, probs, absmax, g)
    w, probs, absmax, g = (t.contiguous() for t in (w, probs, absmax, g))
    dw = torch.empty_like(w)
    dprobs = torch.empty_like(probs)
    fn = build.symbol("mps_combine", "mps_combine_bwd_launch")
    build.check(fn(w.data_ptr(), g.data_ptr(), probs.data_ptr(),
                   absmax.data_ptr(), dw.data_ptr(), dprobs.data_ptr(),
                   w.shape[0], w.shape[1], len(precisions),
                   _packed(precisions),
                   torch.cuda.current_stream(w.device).cuda_stream),
                "mps_combine_bwd")
    mps_combine_bwd.launches += 1
    return dw, dprobs


mps_combine_bwd.launches = 0


def _vjp_bwd(w, probs, precisions, g, absmax=None):
    """The plain backward; ``absmax`` (M,) None reduces each row of w."""
    if absmax is None:
        absmax = torch.amax(w.abs(), dim=1)
    absmax = absmax.reshape(-1, 1)
    dw = torch.zeros_like(w)
    cols = []
    for idx, bits in enumerate(precisions):
        if bits == 0:
            cols.append(torch.zeros(w.shape[0], dtype=w.dtype,
                                    device=w.device))
            continue
        qmax = torch.full((), float(2 ** (bits - 1) - 1), dtype=w.dtype,
                          device=w.device)
        scale = torch.clamp_min(absmax, 1e-8) * quantizers.recip(
            float(qmax), w)
        ratio = w / scale
        inside = (ratio.abs() < qmax).to(w.dtype) \
            + 0.5 * (ratio.abs() == qmax).to(w.dtype)
        q = torch.clamp(torch.round(ratio), -qmax, qmax) * scale
        dw = dw + probs[:, idx:idx + 1] * inside * g
        cols.append(torch.sum(g * q, dim=1))
    return dw, torch.stack(cols, dim=-1)


class _MpsCombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, probs, precisions, given):
        if given is None:
            absmax = torch.empty(w.shape[0], dtype=w.dtype, device=w.device)
            out = mps_combine_fwd(w, probs, precisions, absmax)
        else:
            absmax = given.detach()
            out = mps_combine_fwd(w, probs, precisions, absmax_in=absmax)
        ctx.save_for_backward(w, probs, absmax)
        ctx.precisions = precisions
        return out

    @staticmethod
    def backward(ctx, g):
        w, probs, absmax = ctx.saved_tensors
        dw, dprobs = mps_combine_bwd(w, probs, absmax, g, ctx.precisions)
        return dw, dprobs, None, None


def mps_combine(w: torch.Tensor, probs: torch.Tensor,
                precisions: tuple[int, ...],
                absmax: torch.Tensor | None = None) -> torch.Tensor:
    """Effective weight ``sum_p probs[:, p] * Q_p(w)`` with the
    straight-through gradient.  w: (M, K) f32; ``absmax`` (M,), when
    given, is each row's scale base (held constant), else the row's own
    ``max |w|``."""
    precisions = tuple(int(b) for b in precisions)
    _check(w, probs, precisions)
    return _MpsCombine.apply(w, probs, precisions, absmax)
