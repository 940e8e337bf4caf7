"""Deployment-time weight integerization (``repro.core.quantizers``'s
``integerize_weights``), in torch on the weight's device.

``torch.round`` rounds half to even like ``jnp.round`` and float32
division is IEEE on the CPU and the GPU alike, so the integers and scales
are byte-identical to the JAX package's.  Divisors are tensors on the
weight's device: PyTorch's CUDA division by a Python scalar multiplies
by its rounded reciprocal instead, which is not the same number.
"""
from __future__ import annotations

import torch

# Small epsilon to avoid division by zero scales on all-zero channels.
_EPS = 1e-8


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
    scale = torch.clamp_min(absmax, _EPS) / torch.full(
        (), qmax, dtype=absmax.dtype, device=absmax.device)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    return q, scale
