"""Counter-based random numbers: JAX's threefry2x32 generator in torch.

The JAX package draws every random number through ``jax.random`` with the
default threefry2x32 implementation and ``jax_threefry_partitionable``
on (jax 0.9.0).  This module computes the same functions with torch
integer ops on the key's device, so the port draws the same numbers:

* ``key``, ``fold_in``, ``split``, ``random_bits``, ``uniform`` and
  ``randint`` give the same bits as ``jax.random`` (bit-exact);
* ``normal`` goes through XLA's single-precision ``erf_inv`` polynomial
  written out here, and ``gumbel`` through ``log``.  Both agree with
  ``jax.random`` to a few ULPs, not bitwise: the transcendental
  functions (``log1p``, ``log``, ``sqrt``) are torch's, not XLA's.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words;
a batch of keys (leading dims) draws one independent stream per key.
uint32 arithmetic is int64 arithmetic masked to 32 bits.
"""
from __future__ import annotations

import math

import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x, device=None) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & _M


def key(seed, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` for an int32-range seed: the words
    ``(seed >> 32, seed & 0xFFFFFFFF)`` of the seed as a 32-bit int."""
    seed = int(seed)
    seed = (seed + 2 ** 31) % 2 ** 32 - 2 ** 31     # int32 wrap, as jax
    return torch.tensor([0, seed & _M], dtype=torch.int64, device=device)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) on broadcastable
    uint32-valued int64 tensors; returns the two output words."""
    k1, k2, x1, x2 = torch.broadcast_tensors(k1, k2, x1, x2)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M
    x2 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x1, x2


def _words(k, ndim: int):
    """The key's two words, shaped to broadcast over ``ndim`` trailing
    sample dimensions."""
    shape = k.shape[:-1] + (1,) * ndim
    return k[..., 0].reshape(shape), k[..., 1].reshape(shape)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the counter pair
    ``(0, data)`` under ``k``.  ``data`` (an int or a tensor that
    broadcasts against the key batch) is taken mod 2**32."""
    d = _u32(data, k.device)
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): key ``i`` of ``num`` is the
    threefry of the counter pair ``(0, i)`` -- the same as
    ``fold_in(k, i)``.  Returns ``(num, 2)``."""
    return fold_in(k[None], torch.arange(num, device=k.device))


def random_bits(k: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` (uint32 values in int64):
    the xor of the two threefry words of the element's row-major index
    split into ``(hi, lo)`` words.  Leading key dims stay in front."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    idx = torch.arange(n, device=k.device, dtype=torch.int64).reshape(shape)
    k1, k2 = _words(k, len(shape))
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & _M)
    return y1 ^ y2


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def uniform(k: torch.Tensor, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    """float32 uniform on ``[minval, maxval)``: 23 random mantissa bits
    under exponent 0, minus one, then ``floats * (hi - lo) + lo`` with
    one rounding, as XLA's CPU backend contracts it into a fused
    multiply-add (the float64 product of two float32 values is exact)."""
    bits = random_bits(k, shape)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = _f32(minval, k.device), _f32(maxval, k.device)
    span = (hi - lo).double()
    out = (floats.double() * span + lo.double()).float()
    return torch.maximum(lo, out)


# XLA's single-precision erf_inv (M. Giles, "Approximating the erfinv
# function"), the polynomial chlo.erf_inv lowers to
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function by XLA's polynomial."""
    dev = x.device
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - _f32(2.5, dev), torch.sqrt(w) - _f32(3.0, dev))
    lt5 = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=dev)
    ge5 = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=dev)
    # Horner steps with one rounding each: XLA's CPU backend contracts
    # ``c + p * w`` into a fused multiply-add
    w64 = w.double()
    p = torch.where(lt, lt5[0], ge5[0])
    for i in range(1, len(_ERFINV_LT5)):
        c = torch.where(lt, lt5[i], ge5[i])
        p = (c.double() + p.double() * w64).float()
    res = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       res)


def normal(k: torch.Tensor, shape) -> torch.Tensor:
    """Standard normal float32: ``sqrt(2) * erf_inv(u)`` with ``u``
    uniform on ``(-1, 1)``."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(k, shape, lo, 1.0)
    return _f32(math.sqrt(2), k.device) * erf_inv(u)


def gumbel(k: torch.Tensor, shape) -> torch.Tensor:
    """Standard Gumbel float32: ``-log(-log(u))`` with ``u`` uniform on
    ``[tiny, 1)``."""
    u = uniform(k, shape, torch.finfo(torch.float32).tiny, 1.0)
    return -torch.log(-torch.log(u))


def randint(k: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """int32 integers on ``[minval, maxval)``: two 32-bit draws reduced
    mod the span (``jax.random.randint``'s arithmetic, with its small
    bias for spans that are not powers of two)."""
    k1, k2 = split(k)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & _M if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & _M) % span
    off = ((((hi % span) * mult) & _M) + lo % span) & _M
    return (minval + off % span).to(torch.int32)


def bernoulli(k: torch.Tensor, p, shape) -> torch.Tensor:
    """Booleans, True with probability ``p``: ``uniform < p``."""
    u = uniform(k, shape)
    return u < torch.as_tensor(p, dtype=torch.float32, device=k.device)
