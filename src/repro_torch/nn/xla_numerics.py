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
  converted to float32 (and differentiated as JAX does: the cotangent
  rounded to bf16 first), and a narrow float32 one summed in XLA's order.
* :func:`softmax`: ``jax.nn.softmax``' op sequence, in float32 or (a
  bf16 router) in bf16, and its gradient as XLA computes it in bf16.
* :func:`broadcast`: a parameter broadcast over leading axes, whose
  gradient is summed as XLA's CPU sums bf16 (:func:`sum_bf16`).

One rule for all of them: the copy of XLA's arithmetic is taken for CPU
tensors only, where the port is held to the JAX package's bits.  On the
card each function is torch's own op (``torch.tanh``, ``torch.exp``,
``torch.softmax``, ``torch.matmul`` or ``torch.bmm``): nothing there is
compared with XLA's CPU bits, and the card's products round otherwise
anyway.  The gradient of ``matmul_f32`` is JAX's on either device.
Autograd through the CPU copies gives ``jax.grad``'s values (held in
``tests/test_torch_moe_train.py``): the exp polynomial's derivative is
within 2.3e-7 of ``exp``.

Each was held bitwise against its ``jax.numpy`` counterpart under
``jax.jit`` on the CPU (``tests/test_torch_archs.py``,
``tests/test_torch_moe.py``).
"""
from __future__ import annotations

import itertools

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


class _MatmulF32(torch.autograd.Function):
    """``matmul_f32`` of bf16 operands, with JAX's gradient: the float32
    cotangent rounded to bf16 first (the transpose of
    ``astype(float32)``), then each operand's gradient one bf16 product
    (:func:`matmul`).  Autograd through the CPU's float32 product would
    round only its result: 2.7e-3 relative L2 off JAX's gradient of an
    expert bank's ``w_down``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.device.type == "cpu":
            return torch.matmul(a.float(), b.float())
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return matmul(g, b.transpose(-1, -2)), matmul(a.transpose(-1, -2), g)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a @ b).astype(float32)`` of batched (3-D) bf16 operands as XLA
    computes it under ``jax.jit``: the product is not rounded to bf16 on
    its way to float32.  On the card one bf16 product with a float32
    result (``torch.bmm``'s ``out_dtype``; no float32 copy of a bank); on
    the CPU the float32 product of the operands (exact products of bf16
    values, float32 sums).  Either way differentiated as JAX does
    (:class:`_MatmulF32`)."""
    if a.dtype == b.dtype == torch.bfloat16:
        return _MatmulF32.apply(a, b)
    return torch.matmul(a.float(), b.float())


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
    ``s + x * w`` one rounding.  Elsewhere :func:`matmul` (a bf16 router
    of bf16 master weights: the float32 product rounded once)."""
    if x.dtype != torch.float32 or x.device.type != "cpu" or \
            x.shape[1] > _DOT_MAX_K or w.shape[1] > _DOT_MAX_N:
        return matmul(x, w)
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


def softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, in the logits' dtype, with
    XLA's op sequence on the CPU: ``d = x - max`` (the max held constant
    for the gradient, JAX's ``stop_gradient``), XLA's float32 exp of
    ``d``, the float32 sum of the exps in index order.  float32: a true
    division.  bf16 (a bf16 router of bf16 master weights): ``d``
    rounded to bf16, the sum of the unrounded exps rounded to bf16 and
    the exps rounded to bf16 divided by it (bitwise against
    ``jax.jit(jax.nn.softmax)`` at 4 to 128 experts).  Off the CPU
    ``torch.softmax`` in float32, rounded to the logits' dtype."""
    if logits.device.type != "cpu":
        return torch.softmax(logits.float(), dim=-1).to(logits.dtype)
    if logits.dtype == torch.bfloat16:
        return _SoftmaxBf16.apply(logits)
    d = logits - logits.amax(-1, keepdim=True).detach()
    e, tot = _exp_and_sum(d)
    return e / tot[..., None]


def _exp_and_sum(d: torch.Tensor):
    e = xla_exp(d.float())
    tot = e[..., 0]
    for i in range(1, e.shape[-1]):
        tot = tot + e[..., i]
    return e, tot


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and carried in float32 (a convert pair)."""
    return t.to(torch.bfloat16).float()


class _SoftmaxBf16(torch.autograd.Function):
    """:func:`softmax` of bf16 logits on the CPU, with JAX's gradient of
    ``e / sum(e)`` as XLA computes it there: the max held constant,
    ``e``'s cotangent ``g / tot - sum_j (g_j / tot^2) e_j`` and ``d``'s
    that times ``e``, each op rounded to bf16 but ``1 / tot^2`` (read off
    the compiled backward; bitwise against ``jax.vjp`` of an MoE layer's
    router and input).  Autograd through the float32 division rounds
    other points: 3.0e-3 relative L2 off JAX's input gradient of a bf16
    MoE layer, 6.9e-3 off its router's."""

    @staticmethod
    def forward(ctx, logits):
        e, tot = _exp_and_sum(logits - logits.amax(-1, keepdim=True))
        eb, tb = _bf16(e), _bf16(tot)[..., None]
        ctx.save_for_backward(eb, tb)
        return (eb / tb).to(torch.bfloat16)

    @staticmethod
    def backward(ctx, g):
        eb, tb = ctx.saved_tensors
        g = _bf16(g)
        terms = _bf16(_bf16(g * _bf16(1 / _bf16(tb * tb))) * eb)
        s = terms[..., :1]
        for i in range(1, terms.shape[-1]):
            s = s + terms[..., i:i + 1]
        ge = _bf16(_bf16(g / tb) + _bf16(-_bf16(s)))
        return (ge * eb).to(torch.bfloat16)


# XLA's CPU reduction of a reduced axis longer than this: windows of it,
# then the windows' sums
_REDUCE_WINDOW = 32


def sum_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` (..., C) in bf16 summed over every leading axis as XLA's CPU
    backend sums bf16 under ``jax.jit``: each add rounded to bf16, in
    row-major order; where a reduced axis is longer than 32, in windows of
    32 along it (the windows centred, zero padding split low / high), the
    windows' sums then added in row-major order (bitwise against
    ``lax.reduce`` at the shapes of ``tests/test_torch_hybrid_train.py``,
    odd lengths included)."""
    lead, c = t.shape[:-1], t.shape[-1]
    t = t.float()

    def seq(ranges):
        acc = torch.zeros(c, dtype=torch.float32, device=t.device)
        for idx in itertools.product(*ranges):
            acc = _bf16(acc + t[idx])
        return acc

    if all(d <= _REDUCE_WINDOW for d in lead):
        return seq([range(d) for d in lead]).to(torch.bfloat16)
    wins = []
    for d in lead:
        if d <= _REDUCE_WINDOW:
            wins.append([range(d)])
            continue
        n = -(-d // _REDUCE_WINDOW)
        low = (n * _REDUCE_WINDOW - d) // 2
        wins.append([range(max(0, k * _REDUCE_WINDOW - low),
                           min(d, (k + 1) * _REDUCE_WINDOW - low))
                     for k in range(n)])
    acc = torch.zeros(c, dtype=torch.float32, device=t.device)
    for ranges in itertools.product(*wins):
        acc = _bf16(acc + seq(ranges))
    return acc.to(torch.bfloat16)


class _Broadcast(torch.autograd.Function):
    """``w`` (C,) broadcast to ``shape`` (..., C); the gradient summed by
    :func:`sum_bf16` for a bf16 CPU ``w``, by ``sum`` elsewhere."""

    @staticmethod
    def forward(ctx, w, shape):
        ctx.cpu_bf16 = w.device.type == "cpu" and w.dtype == torch.bfloat16
        return w.expand(shape)

    @staticmethod
    def backward(ctx, g):
        if ctx.cpu_bf16:
            return sum_bf16(g), None
        return g.reshape(-1, g.shape[-1]).sum(0), None


def broadcast(w: torch.Tensor, shape) -> torch.Tensor:
    """``w`` (C,) broadcast to ``shape`` (..., C), as ``w[None, ...]``
    is in the JAX package: the gradient of a bf16 ``w`` on the CPU is
    XLA's bf16 sum (:func:`sum_bf16`), not torch's float32 one (1.3e-2
    relative L2 off JAX's gradient of a bf16 Mamba-2 layer's
    ``dt_bias``, 9e-3 off its conv weights')."""
    return _Broadcast.apply(w, tuple(shape))
