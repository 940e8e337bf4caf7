"""Quantizers of the joint pruning + mixed-precision search
(``repro.core.quantizers``), in torch on the tensor's device.

* weights -> symmetric min-max, per-channel scale, signed integer grid
* activations -> PACT (learnable clip value alpha), unsigned grid
* 0-bit weight "quantization" == structured pruning (constant zero)

Fake-quant with the straight-through estimator (STE).  ``jnp.clip`` is
``minimum(maximum(x, lo), hi)``, and JAX splits the gradient of a
maximum or minimum evenly at a tie, so ``jax.grad`` of a clip is 0.5 at
either bound; ``torch.clamp`` passes all of it.  A row's absmax element
lands on ``+-qmax`` whenever ``absmax / scale`` rounds back to ``qmax``,
and PACT's clip ties at 0 and at ``alpha``, so the clips here are built
from :func:`maximum` and :func:`minimum`, which split ties as JAX does.

``torch.round`` rounds half to even like ``jnp.round`` and float32
division is IEEE on the CPU and the GPU alike.  The reference's search
runs under ``jax.jit``, where XLA rewrites a division by a constant into
a multiplication by the constant's float32 reciprocal; the fake-quant
scales here (``absmax / qmax``, ``alpha / levels``) are computed that
way, :func:`recip`, so that values land on the same side of every
rounding boundary.  ``integerize_weights`` (deployment) divides, as the
reference's export does.  Divisors are tensors on the weight's device:
PyTorch's CUDA division by a Python scalar multiplies by its rounded
reciprocal instead, which is not the same number.
"""
from __future__ import annotations

import torch

# Small epsilon to avoid division by zero scales on all-zero channels.
_EPS = 1e-8


def _const(v, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=like.dtype, device=like.device)


def recip(v: float, like: torch.Tensor) -> torch.Tensor:
    """The float32 reciprocal of the constant ``v`` (XLA's rewrite of a
    division by a constant), as a scalar tensor on ``like``'s device."""
    return torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        v, dtype=torch.float32).to(like.device)


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    return g.sum_to_size(shape) if g.shape != shape else g


class _Extremum(torch.autograd.Function):
    """Elementwise max (``sign=1``) or min (``sign=-1``) whose gradient
    splits evenly between the operands at a tie (``jax.lax.max``)."""

    @staticmethod
    def forward(ctx, a, b, sign):
        ctx.save_for_backward(a, b)
        ctx.sign = sign
        return torch.maximum(a, b) if sign > 0 else torch.minimum(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        wins = a > b if ctx.sign > 0 else a < b
        wa = wins.to(g.dtype) + 0.5 * (a == b).to(g.dtype)
        ga = _sum_to(g * wa, a.shape) if ctx.needs_input_grad[0] else None
        gb = _sum_to(g * (1 - wa), b.shape) if ctx.needs_input_grad[1] \
            else None
        return ga, gb, None


def _as_tensor(v, like):
    return v if torch.is_tensor(v) else _const(v, like)


def maximum(a, b):
    """``jnp.maximum`` with JAX's tie-splitting gradient."""
    b = _as_tensor(b, a)
    return _Extremum.apply(a, b, 1)


def minimum(a, b):
    """``jnp.minimum`` with JAX's tie-splitting gradient."""
    b = _as_tensor(b, a)
    return _Extremum.apply(a, b, -1)


def clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, gradient 0.5 at a
    tie with either bound."""
    return minimum(maximum(x, lo), hi)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round() with identity gradient (straight-through estimator)."""
    return x + (torch.round(x) - x).detach()


def quantize_weights_symmetric(w: torch.Tensor, bits: int,
                               channel_axis: int = 0,
                               absmax: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Symmetric min-max per-channel fake quantization of weights.

    ``bits == 0`` returns zeros (structured pruning of the channel).  The
    scale, ``max|w| / (2^(b-1) - 1)`` per output channel, is held
    constant for the gradient; the clip comes before the round, so the
    STE mask is ``1{|w/s| < qmax}`` (0.5 on the bound).  ``absmax``, when
    given (broadcastable to w, the channel axis kept), replaces the
    per-channel ``max|w|``: a weight split over ranks passes the maximum
    over every rank's part.
    """
    if bits == 0:
        return torch.zeros_like(w)
    if bits >= 32:  # identity / float passthrough
        return w
    qmax = float(2 ** (bits - 1) - 1)
    if absmax is None:
        reduce_axes = tuple(i for i in range(w.ndim) if i != channel_axis)
        absmax = torch.amax(w.detach().abs(), dim=reduce_axes, keepdim=True)
    else:
        absmax = absmax.detach()
    scale = torch.clamp_min(absmax, _EPS) * recip(qmax, w)
    q = ste_round(clip(w / scale, -qmax, qmax))
    return q * scale


def quantize_weights_multi(w: torch.Tensor, precisions: tuple[int, ...],
                           channel_axis: int = 0,
                           absmax: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Stack of fake-quantized variants of ``w``: shape (|P|, *w.shape);
    ``absmax`` as in :func:`quantize_weights_symmetric`."""
    return torch.stack([quantize_weights_symmetric(w, b, channel_axis,
                                                   absmax)
                        for b in precisions])


def pact_quantize(x: torch.Tensor, alpha, bits: int) -> torch.Tensor:
    """PACT activation fake quantization: ``clip(x, 0, alpha)`` on an
    unsigned ``bits``-bit grid of step ``alpha / (2^b - 1)``.  The
    gradient reaches a tensor ``alpha`` through the clip bound and the
    step, and ``x`` through the STE.

    A Python-number ``alpha`` is a fixed clip (quant mode, where the
    reference closes over the plan's values and XLA folds the step into
    the constant ``alpha / levels``): then ``clipped / step`` is
    ``clipped * (1 / step)`` with the float32 reciprocal, as XLA
    computes it."""
    if bits >= 32:
        return torch.relu(x)
    levels = float(2 ** bits - 1)
    if not torch.is_tensor(alpha):
        a = max(_const(alpha, x), _const(_EPS, x))
        step = a / _const(levels, x)
        inv = torch.ones((), dtype=x.dtype, device=x.device) / step
        return ste_round(clip(x, 0.0, float(a)) * inv) * step
    alpha = maximum(alpha, _EPS)
    clipped = clip(x, 0.0, alpha)
    step = alpha * recip(levels, x)
    return ste_round(clipped / step) * step


def quantize_acts_multi(x: torch.Tensor, alpha: torch.Tensor,
                        precisions: tuple[int, ...]) -> torch.Tensor:
    """Stack of PACT-quantized variants of ``x``: shape (|Px|, *x.shape)."""
    return torch.stack([pact_quantize(x, alpha, b) for b in precisions])


def integerize_weights(w: torch.Tensor, bits: int, channel_axis: int = 0):
    """Return (int8 weights, per-channel scale) on the true integer grid.

    ``bits == 0`` channels should have been removed already; if present
    they map to 0.
    """
    if bits == 0:
        shape = tuple(1 if i != channel_axis else w.shape[i]
                      for i in range(w.ndim))
        return (torch.zeros(w.shape, dtype=torch.int8, device=w.device),
                torch.zeros(shape, dtype=w.dtype, device=w.device))
    qmax = float(2 ** (bits - 1) - 1)
    reduce_axes = tuple(i for i in range(w.ndim) if i != channel_axis)
    absmax = torch.amax(w.abs(), dim=reduce_axes, keepdim=True)
    scale = torch.clamp_min(absmax, _EPS) / _const(qmax, absmax)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    return q, scale
