"""Packed mixed-precision linear layers for quantized serving (Fig. 3).

After the search assigns per-output-channel bit-widths, a layer's
channels are reordered into contiguous per-precision groups (paper
Fig. 3), bit-packed, and served through one ``quant_matmul`` per group.
Activations are quantized **per row**, which keeps the product
batch-invariant: a request decodes to the same tokens alone or beside
others.  Packing is byte-identical to ``repro.nn.quantized``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core import discretize, quantizers
from repro_torch.kernels.quant_matmul import ops as qops


def quantize_activations_per_row(x: torch.Tensor):
    """Symmetric int8 activation quantization with one scale per row.

    x: (M, K) float. Returns (xq int8 (M, K), sx (M, 1) f32).
    """
    x = x.float()
    # ``absmax / 127`` as the reference computes it under jax.jit: XLA
    # turns the division by the constant into a multiplication by its
    # float32 reciprocal, and an ulp in sx can move x / sx across a
    # rounding boundary
    sx = torch.clamp_min(x.abs().amax(-1, keepdim=True), 1e-8) * \
        quantizers.recip(127.0, x)
    xq = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
    return xq, sx


def pack_channelwise(w: torch.Tensor, channel_bits: np.ndarray,
                     perm: np.ndarray | None = None):
    """Reorder + bit-pack one layer (paper Fig. 3) on ``w``'s device.

    w: (C_out, C_in) float weights; channel_bits: (C_out,) ints (0 =
    pruned); ``perm`` overrides the reorder permutation (e.g. a plan's
    stored one).  Returns ``(packed, perm, kept)``: ``packed`` is
    ``[(bits, wq_packed (Ni, ceil(C_in*bits/8)) int8, scales (Ni,) f32),
    ...]`` in ascending-bits order, ``kept`` counts the unpruned
    channels; a fully pruned layer gives ``packed == []``.
    """
    if perm is None:
        perm = discretize.reorder_permutations(
            {"gamma": {"l": channel_bits}})["l"]
    perm = np.asarray(perm)
    bits_sorted = np.asarray(channel_bits)[perm]
    w_sorted = w[torch.as_tensor(perm, device=w.device)]
    packed = []
    for b in sorted(set(int(x) for x in bits_sorted if x > 0)):
        rows = w_sorted[torch.as_tensor(bits_sorted == b, device=w.device)]
        qi, scale = quantizers.integerize_weights(rows, b, 0)
        pad = (-rows.shape[1]) % (8 // b)
        if pad:
            qi = torch.nn.functional.pad(qi, (0, pad))
        packed.append((b, qops.pack_weights(qi, b), scale[:, 0]))
    kept = int(np.sum(bits_sorted > 0))
    return packed, perm, kept


def mixed_precision_matmul(x: torch.Tensor, packed_layers) -> torch.Tensor:
    """Serve ``y = x @ W^T`` for a reordered mixed-precision layer: one
    quant_matmul per precision group with ``sx = 1``, outputs
    concatenated, per-row activation scales applied after the concat.

    x: (M, K) float; returns (M, kept) f32 in permuted (ascending-bits)
    channel order; an empty ``packed_layers`` gives an (M, 0) result.
    """
    if not packed_layers:
        return torch.zeros(x.shape[:-1] + (0,), dtype=torch.float32,
                           device=x.device)
    xq, sx_row = quantize_activations_per_row(x)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    outs = [qops.quant_matmul(xq, wq, sw, one, w_bits=bits)
            for bits, wq, sw in packed_layers]
    return torch.cat(outs, dim=-1) * sx_row


class PackedLinear(nn.Module):
    """A bit-packed mixed-precision weight standing in for a dense
    ``(n_in, n_out)`` projection.

    ``forward`` runs one ``quant_matmul`` per precision group and scatters
    the concatenated outputs back to the original channel order, so pruned
    channels are exactly 0; the result is cast to ``x.dtype``.
    """

    def __init__(self, groups, out_index: torch.Tensor, n_in: int,
                 n_out: int):
        super().__init__()
        self.bits = tuple(int(b) for b, _, _ in groups)
        for i, (_, wq, sw) in enumerate(groups):
            self.register_buffer(f"wq{i}", wq)
            self.register_buffer(f"sw{i}", sw)
        self.register_buffer("out_index", out_index.to(torch.int32))
        self.register_buffer("_index", out_index.long(), persistent=False)
        self.n_in = int(n_in)
        self.n_out = int(n_out)

    @property
    def groups(self) -> tuple:
        """((bits, wq_packed, scales), ...) in ascending bits."""
        return tuple((b, getattr(self, f"wq{i}"), getattr(self, f"sw{i}"))
                     for i, b in enumerate(self.bits))

    @classmethod
    def from_dense(cls, w_in_out: torch.Tensor, channel_bits: np.ndarray,
                   perm: np.ndarray | None = None) -> "PackedLinear":
        """Pack a ``(n_in, n_out)`` projection (the LM's ``w`` layout)."""
        w = torch.as_tensor(w_in_out).float()
        packed, perm, kept = pack_channelwise(w.T, channel_bits, perm=perm)
        return cls(packed, torch.as_tensor(perm[:kept], device=w.device),
                   n_in=w.shape[0], n_out=w.shape[1])

    @property
    def kept(self) -> int:
        return int(self.out_index.shape[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, self.n_in)
        full = torch.zeros((x2.shape[0], self.n_out), dtype=torch.float32,
                           device=x.device)
        if self.bits:
            full[:, self._index] = mixed_precision_matmul(x2, self.groups)
        return full.reshape(lead + (self.n_out,)).to(x.dtype)
