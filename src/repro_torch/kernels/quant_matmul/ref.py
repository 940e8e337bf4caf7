"""Plain PyTorch versions for quant_matmul: the bit packing and the
int32-exact product the CUDA kernel is held to."""
from __future__ import annotations

import torch


def pack_weights(wq: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack signed ``bits``-bit integers (N, K) little-endian into int8
    (N, K*bits/8), on ``wq``'s device.  K must be a multiple of 8/bits.
    Byte-identical to ``repro.kernels.quant_matmul.ref.pack_weights``."""
    if bits == 8:
        return wq.to(torch.int8)
    per = 8 // bits
    n, k = wq.shape
    if k % per:
        raise ValueError(f"K={k} is not a multiple of {per} ({bits}-bit)")
    u = (wq.to(torch.int32) & ((1 << bits) - 1)).reshape(n, k // per, per)
    shifts = torch.arange(per, dtype=torch.int32, device=wq.device) * bits
    # the fields are disjoint, so the sum is their bitwise or
    return (u << shifts).sum(-1).to(torch.uint8).view(torch.int8)


def unpack_weights(wq_packed: torch.Tensor, bits: int, k: int
                   ) -> torch.Tensor:
    """Inverse of :func:`pack_weights`, sign-extending like the TPU
    kernel's ``_unpack``; returns int8 (N, k)."""
    if bits == 8:
        return wq_packed[:, :k]
    per = 8 // bits
    u = wq_packed.view(torch.uint8).to(torch.int32)
    shifts = torch.arange(per, dtype=torch.int32, device=u.device) * bits
    v = (u[:, :, None] >> shifts) & ((1 << bits) - 1)
    v = torch.where(v >= (1 << (bits - 1)), v - (1 << bits), v)
    return v.reshape(u.shape[0], -1)[:, :k].to(torch.int8)


def quant_matmul_ref(xq: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                     sx: torch.Tensor) -> torch.Tensor:
    """xq: (M, K) int8; wq: (N, K) int8 *unpacked*; sw: (N,) f32; sx: one
    f32.  Returns ``float(acc) * sw * sx`` with ``acc`` the exact integer
    sum: float64 holds every partial sum of 127*127*K exactly, so this is
    int32 accumulation, on any device (CUDA has no int32 matmul)."""
    acc = xq.to(torch.float64) @ wq.to(torch.float64).T
    return acc.to(torch.float32) * sw[None, :] * sx.reshape(())
