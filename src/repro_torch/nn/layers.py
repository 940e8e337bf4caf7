"""Functional NN layers over dicts of tensors (``repro.nn.layers``).

The JAX package's layouts are kept at every public function: NHWC
activations, conv weights (C_out, C_in // groups, K_y, K_x) with the
output-channel axis 0 (the per-channel MPS convention), linear weights
(C_out, C_in).  Convolutions run as ``F.conv2d`` on NCHW views of the
NHWC tensors (a channels-last layout for cuDNN); XLA's "SAME" padding,
which puts the odd pixel at the end, is applied explicitly.

On the card, cuDNN runs float32 convolutions in TF32 unless told not
to; the search path calls :func:`full_precision` so that convolutions
and matrix products keep float32, like the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import rng as trng


def full_precision():
    """Turn TF32 off for cuDNN convolutions and cuBLAS matrix products
    (cuDNN's default is TF32, about three decimal digits)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def he_init(key, shape, fan_in):
    """He-normal float32 from a threefry key (``core/rng.py``)."""
    scale = torch.tensor(math.sqrt(2.0 / fan_in), dtype=torch.float32,
                         device=key.device)
    return trng.normal(key, shape) * scale


def _same_pad(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride: int = 1, padding="SAME", groups: int = 1) -> torch.Tensor:
    """x: (N, H, W, C_in); w: (C_out, C_in//groups, K_y, K_x)."""
    xc = x.permute(0, 3, 1, 2)
    if xc.device.type == "cpu":
        # PyTorch's CPU backward of a strided 1x1 convolution over a
        # channels-last input crashes at some shapes (torch 2.13: batch
        # 32, 64x64, 4 -> 8 channels, stride 2); the CPU takes NCHW
        xc = xc.contiguous()
    if padding == "SAME":
        top, bottom = _same_pad(x.shape[1], w.shape[2], stride)
        left, right = _same_pad(x.shape[2], w.shape[3], stride)
        if top == bottom and left == right:
            out = F.conv2d(xc, w, None, stride, (top, left), 1, groups)
        else:
            out = F.conv2d(F.pad(xc, (left, right, top, bottom)), w, None,
                           stride, 0, 1, groups)
    elif padding == "VALID":
        out = F.conv2d(xc, w, None, stride, 0, 1, groups)
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    out = out.permute(0, 2, 3, 1)
    if b is not None:
        out = out + b
    return out


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None
           ) -> torch.Tensor:
    """x: (..., C_in); w: (C_out, C_in)."""
    out = x @ w.T
    if b is not None:
        out = out + b
    return out


# ---------------------------------------------------------------------------
# BatchNorm with running statistics kept in an explicit state dict.
# ---------------------------------------------------------------------------

def bn_init(c: int, device=None):
    kw = dict(dtype=torch.float32, device=device)
    return {"scale": torch.ones((c,), **kw), "bias": torch.zeros((c,), **kw),
            "mean": torch.zeros((c,), **kw), "var": torch.ones((c,), **kw)}


def batchnorm(x: torch.Tensor, p: dict, train: bool, momentum: float = 0.9,
              eps: float = 1e-5):
    """Returns (y, updated_params). Channel axis is the last one; the
    updated running statistics carry no gradient."""
    if train:
        axes = tuple(range(x.ndim - 1))
        mean = torch.mean(x, dim=axes)
        var = torch.var(x, dim=axes, unbiased=False)
        new_p = dict(p)
        new_p["mean"] = (momentum * p["mean"]
                         + (1 - momentum) * mean).detach()
        new_p["var"] = (momentum * p["var"] + (1 - momentum) * var).detach()
    else:
        mean, var = p["mean"], p["var"]
        new_p = p
    inv = torch.rsqrt(var + eps)
    y = (x - mean) * inv * p["scale"] + p["bias"]
    return y, new_p


def fold_bn_into_conv(w: torch.Tensor, b: torch.Tensor | None, bn: dict,
                      eps: float = 1e-5):
    """Fold BN (inference form) into the preceding conv/linear (paper 4.2).

    w has C_out on axis 0. Returns (w_folded, b_folded).
    """
    var = bn["var"].detach()
    inv = 1.0 / torch.sqrt(var + torch.tensor(eps, dtype=var.dtype,
                                              device=var.device))
    g = bn["scale"].detach() * inv                            # (C,)
    shape = (w.shape[0],) + (1,) * (w.ndim - 1)
    w_f = w * g.reshape(shape)
    b0 = b if b is not None else torch.zeros((w.shape[0],), dtype=w.dtype,
                                             device=w.device)
    b_f = (b0 - bn["mean"]) * g + bn["bias"]
    return w_f, b_f


def max_pool(x, k=2, stride=2):
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, stride).permute(0, 2, 3, 1)


def avg_pool(x, k=2, stride=2):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, stride).permute(0, 2, 3, 1)


def global_avg_pool(x):
    return torch.mean(x, dim=(1, 2))
