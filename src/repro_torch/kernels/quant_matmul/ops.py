"""``quant_matmul``: the int8 x bit-packed int8 serving product (kernel
K1, ``csrc/quant_matmul.cu``).  A CUDA tensor launches the kernel; a CPU
tensor takes the plain version of ``ref.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quant_matmul import ref as _ref

pack_weights = _ref.pack_weights

_SCRATCH: dict = {}


def _split_scratch(dev: torch.device, stream: int):
    """The tile kernel's split-K scratch for launches on ``stream``: int32
    tile sums and arrival counts, sized by the kernel itself
    (``qmm_scratch_ints``, which ``qmm_launch`` checks) and made at the
    first launch on that (device, stream).  Launches on one stream use it
    in order, and the kernel leaves all of it at zero; two streams never
    share one."""
    key = (dev, stream)
    pair = _SCRATCH.get(key)
    if pair is None:
        ints = build.symbol("quant_matmul", "qmm_scratch_ints")
        pair = (torch.zeros(ints(0), dtype=torch.int32, device=dev),
                torch.zeros(ints(1), dtype=torch.int32, device=dev))
        _SCRATCH[key] = pair
    return pair


def quant_matmul(xq: torch.Tensor, wq_packed: torch.Tensor,
                 sw: torch.Tensor, sx: torch.Tensor, w_bits: int = 8
                 ) -> torch.Tensor:
    """Y = (Xq @ Wq^T) * sw * sx.  xq: (M, K) int8; wq_packed:
    (N, ceil(K*w_bits/8)) int8; sw: (N,) f32; sx: one f32 element.
    Returns (M, N) f32."""
    if w_bits not in (2, 4, 8):
        raise ValueError(f"w_bits must be 2, 4 or 8, got {w_bits}")
    if xq.dim() != 2 or wq_packed.dim() != 2:
        raise ValueError("xq and wq_packed must be 2-D")
    m, k = xq.shape
    n = wq_packed.shape[0]
    per = 8 // w_bits
    kp = -(-k // per)
    if wq_packed.shape[1] != kp or sw.shape != (n,) or sx.numel() != 1:
        raise ValueError(
            f"shape mismatch: xq {tuple(xq.shape)}, wq_packed "
            f"{tuple(wq_packed.shape)} (want (N, {kp})), sw "
            f"{tuple(sw.shape)}, sx {tuple(sx.shape)}")
    if (xq.dtype, wq_packed.dtype, sw.dtype, sx.dtype) != (
            torch.int8, torch.int8, torch.float32, torch.float32):
        raise TypeError("quant_matmul takes int8 xq / wq_packed and "
                        "float32 sw / sx")
    if xq.device.type == "cpu":
        return _ref.quant_matmul_ref(
            xq, _ref.unpack_weights(wq_packed, w_bits, k), sw, sx)
    for t in (wq_packed, sw, sx):
        if t.device != xq.device:
            raise ValueError("quant_matmul operands are on different "
                             "devices")
    if xq.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu, not "
                         f"{xq.device}")
    if not (xq.is_contiguous() and wq_packed.is_contiguous()
            and sw.is_contiguous()):
        raise ValueError("quant_matmul needs contiguous operands")
    y = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    if m == 0 or n == 0 or k == 0:
        return y.zero_()
    fn = build.load("quant_matmul")
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    part, count = _split_scratch(xq.device, stream)
    build.check(fn(xq.data_ptr(), wq_packed.data_ptr(), sw.data_ptr(),
                   sx.data_ptr(), y.data_ptr(), m, n, k, kp, w_bits,
                   part.data_ptr(), part.numel(), count.data_ptr(),
                   count.numel(), stream), "quant_matmul")
    quant_matmul.launches += 1
    return y


quant_matmul.launches = 0
