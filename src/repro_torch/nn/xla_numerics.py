"""Numerics of XLA's CPU backend under ``jax.jit``, for the places where
the port must give the JAX package's bits on the CPU: a one-ulp
difference can move a greedy token (the attention softcap) or an MoE
gate, and capacity-based dropping turns that into other tokens.

* :func:`xla_tanh`, :func:`xla_exp`: float32 transcendentals.  XLA emits
  its own polynomials, not libm's functions and not torch's.  Every
  Horner step ``c + p * x`` is an FMA there (one rounding); here it is
  computed in float64, where the product of two float32 values is exact.
* :func:`matmul`, :func:`matmul_f32`, :func:`dot_f32`: products as XLA
  forms them: bf16 ones rounded once, bf16 ones kept in float32 when only
  converted to float32, and a narrow float32 one summed in XLA's order.
* :func:`softmax_f32`: ``jax.nn.softmax``' op sequence.

One rule for all of them: the copy of XLA's arithmetic is taken for CPU
tensors only, where the port is held to the JAX package's bits.  On the
card each function is torch's own op (``torch.tanh``, ``torch.exp``,
``torch.softmax``, ``torch.matmul`` or ``torch.bmm``): nothing there is compared with
XLA's CPU bits, and the card's products round otherwise anyway.

Each was held bitwise against its ``jax.numpy`` counterpart under
``jax.jit`` on the CPU (``tests/test_torch_archs.py``,
``tests/test_torch_moe.py``).
"""
from __future__ import annotations

import torch


def _f32(v: float) -> float:
    return torch.tensor(v, dtype=torch.float32).item()


# XLA's float32 tanh on the CPU: the input clamped to +-_TANH_CLAMP, then
# x * P(x^2) / Q(x^2) with these float32 coefficients (highest power
# first), Horner steps contracted into FMAs; |x| < _TANH_SMALL passes
# through unchanged.
_TANH_NUM = tuple(_f32(c) for c in (
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
    4.89352455891786e-03))
_TANH_DEN = tuple(_f32(c) for c in (
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
    4.89352518554385e-03))
_TANH_CLAMP = _f32(7.99881172180175781)
_TANH_SMALL = 0.0004


def xla_tanh(x: torch.Tensor) -> torch.Tensor:
    """float32 ``jnp.tanh``: the input clamped, ``x * P(x^2) / Q(x^2)``,
    and ``x`` itself below ``_TANH_SMALL``.  ``torch.tanh`` off the CPU."""
    if x.device.type != "cpu":
        return torch.tanh(x)
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = (xc * xc).double()

    def horner(coeffs):
        p = torch.full_like(xc, coeffs[0])
        for c in coeffs[1:]:
            p = (c + p.double() * x2).float()
        return p

    r = xc * horner(_TANH_NUM) / horner(_TANH_DEN)
    return torch.where(x.abs() < _TANH_SMALL, x, r)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    return (torch.as_tensor(a).double() * b + c).float()


# Cephes' expf: exp(x) = 2^n * e^r, n = floor(x log2(e) + 1/2), r = x - n
# ln 2 in two parts, e^r = 1 + r + r^2 P(r)
_EXP_LOG2E = _f32(1.44269504088896341)
_EXP_LN2 = (_f32(0.693359375), _f32(-2.12194440e-4))
_EXP_P = tuple(_f32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))
_F32_TINY = _f32(2.0 ** -126)


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 ``jnp.exp``: Cephes' range reduction and polynomial with
    the input clamped to [-104, 88.8] and 2^n built from its exponent
    bits, n clamped to [-127, 127]; a subnormal result is flushed to
    zero.  ``torch.exp`` off the CPU."""
    if x.device.type != "cpu":
        return torch.exp(x.float())
    xc = torch.clamp(x.float(), -104.0, _f32(88.8))
    n = torch.floor(_fma(xc, _EXP_LOG2E, 0.5))
    n = torch.clamp(n, -127.0, 127.0)
    r = _fma(n, -_EXP_LN2[0], xc.double())
    r = _fma(n, -_EXP_LN2[1], r.double())
    z = (r * r).double()
    rd = r.double()
    y = _fma(rd, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = _fma(y, rd, c)
    y = _fma(y, z, rd)
    y = 1.0 + y
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * scale
    return torch.where(out < _F32_TINY, torch.zeros_like(out), out)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``.  bf16 operands on the CPU are multiplied in float32 and
    the result rounded to bf16 once, as XLA's CPU dot does (products of
    bf16 values are exact in float32); torch's CPU bf16 kernel rounds a
    few outputs a row count of ~16 and up differently.  Elsewhere
    ``torch.matmul``."""
    if a.device.type == "cpu" and a.dtype == b.dtype == torch.bfloat16:
        return torch.matmul(a.float(), b.float()).to(torch.bfloat16)
    return torch.matmul(a, b)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a @ b).astype(float32)`` of batched bf16 operands as XLA
    computes it under ``jax.jit``: the product is not rounded to bf16 on
    its way to float32.  On the card one bf16 product with a float32
    result (``torch.bmm``'s ``out_dtype``; no float32 copy of a bank); on
    the CPU the float32 product of the operands (exact products of bf16
    values, float32 sums)."""
    if a.device.type == "cpu":
        return torch.matmul(a.float(), b.float())
    return torch.bmm(a, b, out_dtype=torch.float32)


# the shapes at which dot_f32's order was held bitwise against XLA's CPU
# dot: T in 1..200 rows, K <= 2048, N <= 16 (the MoE smoke archs' router
# is K = 64, N = 4).  At K = 4096 and N = 16, or N >= 17, XLA sums in
# other orders (at K = 64 and N >= 17 torch.matmul's)
_DOT_MAX_K, _DOT_MAX_N = 2048, 16


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of (T, K) and (K, N).  A float32 product on the CPU with
    K <= ``_DOT_MAX_K`` and N <= ``_DOT_MAX_N`` is summed in the order of
    XLA's CPU dot there: one row in k order, more rows in four partial
    sums over k mod 4 combined as ``(s0 + s1) + (s2 + s3)``, each step
    ``s + x * w`` one rounding.  Elsewhere ``torch.matmul``."""
    if x.dtype != torch.float32 or x.device.type != "cpu" or \
            x.shape[1] > _DOT_MAX_K or w.shape[1] > _DOT_MAX_N:
        return torch.matmul(x, w)
    t, k = x.shape
    lanes = 1 if t == 1 else 4
    kp = -(-k // lanes) * lanes            # zero products change no sum
    xd = torch.zeros((t, kp), dtype=torch.float64)
    xd[:, :k] = x.double()
    wd = torch.zeros((kp, w.shape[1]), dtype=torch.float64)
    wd[:k] = w.double()
    acc = torch.zeros((lanes, t, w.shape[1]), dtype=torch.float32)
    for i in range(0, kp, lanes):
        acc = (acc.double() + xd[:, i:i + lanes].T[:, :, None]
               * wd[i:i + lanes, None, :]).float()
    if lanes == 1:
        return acc[0]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def softmax_f32(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``' op sequence over the last axis, in float32:
    ``exp(x - max) / sum``, with XLA's exp, the sum in index order and a
    true division.  ``torch.softmax`` off the CPU."""
    x = logits.float()
    if x.device.type != "cpu":
        return torch.softmax(x, dim=-1)
    e = xla_exp(x - x.amax(-1, keepdim=True))
    tot = e[..., 0]
    for i in range(1, e.shape[-1]):
        tot = tot + e[..., i]
    return e / tot[..., None]
