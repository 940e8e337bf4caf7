"""``mps_combine``: the search's effective weight (paper Eq. 5, kernel
K4, ``csrc/mps_combine.cu``) with the reference's straight-through
gradient.

``mps_combine`` is a ``torch.autograd.Function``.  The scale is
``max(absmax, 1e-8) * (1 / qmax)`` with the float32 reciprocal, as the
reference computes it under ``jax.jit`` (``core.quantizers.recip``).  Its forward is
:func:`mps_combine_fwd`, which launches the kernel for a CUDA tensor and
runs the plain version (``ref.py``) for a CPU one.  Its backward is the
JAX package's ``_vjp_bwd`` (``repro/kernels/mps_combine/ops.py``) in
plain torch ops, the scale held constant::

    dW[i, k]       = g[i, k] * sum_p probs[i, p] * (1{|r| < qmax_p}
                                                 + 0.5 * 1{|r| = qmax_p})
    dprobs[i, p]   = sum_k g[i, k] * Q_p(W)[i, k]
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


def mps_combine_fwd(w: torch.Tensor, probs: torch.Tensor,
                    precisions: tuple[int, ...]) -> torch.Tensor:
    """Eq. 5 forward (kernel K4).  w: (M, K) f32; probs: (M, |P|) f32.
    Returns (M, K) f32."""
    _check(w, probs, precisions)
    if w.device.type == "cpu":
        return _ref.mps_combine_ref(w, probs, precisions)
    if w.device.type != "cuda" or probs.device != w.device:
        raise ValueError(f"mps_combine runs on one cuda device or the cpu, "
                         f"got w on {w.device}, probs on {probs.device}")
    if w.dtype != torch.float32 or probs.dtype != torch.float32:
        raise TypeError(f"mps_combine takes float32 w and probs, got "
                        f"{w.dtype}, {probs.dtype}")
    w = w.contiguous()
    probs = probs.contiguous()
    out = torch.empty_like(w)
    packed = sum(int(b) << (8 * i) for i, b in enumerate(precisions))
    fn = build.load("mps_combine")
    build.check(fn(w.data_ptr(), probs.data_ptr(), out.data_ptr(),
                   w.shape[0], w.shape[1], len(precisions), packed,
                   torch.cuda.current_stream(w.device).cuda_stream),
                "mps_combine")
    mps_combine_fwd.launches += 1
    return out


mps_combine_fwd.launches = 0


def _vjp_bwd(w, probs, precisions, g):
    absmax = torch.amax(w.abs(), dim=1, keepdim=True)
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
    def forward(ctx, w, probs, precisions):
        ctx.save_for_backward(w, probs)
        ctx.precisions = precisions
        return mps_combine_fwd(w, probs, precisions)

    @staticmethod
    def backward(ctx, g):
        w, probs = ctx.saved_tensors
        dw, dprobs = _vjp_bwd(w, probs, ctx.precisions, g)
        return dw, dprobs, None


def mps_combine(w: torch.Tensor, probs: torch.Tensor,
                precisions: tuple[int, ...]) -> torch.Tensor:
    """Effective weight ``sum_p probs[:, p] * Q_p(w)`` with the
    straight-through gradient.  w: (M, K) f32."""
    precisions = tuple(int(b) for b in precisions)
    _check(w, probs, precisions)
    return _MpsCombine.apply(w, probs, precisions)
