"""``ssd_scan``: the Mamba-2 inter-chunk state pass (kernel K5,
``csrc/ssd_scan.cu``).  A CUDA tensor launches the kernel; a CPU tensor
takes the plain version of ``ref.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ref as _ref

ssd_scan_ref = _ref.ssd_scan_ref


def ssd_scan(decay: torch.Tensor, s_in: torch.Tensor, s0: torch.Tensor):
    """decay: (C, H); s_in: (C, H, P, N); s0: (H, P, N); all float32 and
    contiguous.  Returns ``(prefix (C, H, P, N), final (H, P, N))``, with
    ``prefix[c]`` the state before chunk c and
    ``state = decay[c] * state + s_in[c]`` from ``state = s0``."""
    if decay.dim() != 2 or s_in.dim() != 4 or s0.dim() != 3 or \
            s_in.shape[:2] != decay.shape or s_in.shape[1:] != s0.shape:
        raise ValueError(f"ssd_scan takes decay (C, H), s_in (C, H, P, N) "
                         f"and s0 (H, P, N), got {tuple(decay.shape)}, "
                         f"{tuple(s_in.shape)}, {tuple(s0.shape)}")
    if any(t.dtype != torch.float32 for t in (decay, s_in, s0)):
        raise TypeError(f"ssd_scan takes float32 operands, got "
                        f"{decay.dtype}, {s_in.dtype}, {s0.dtype}")
    if not all(t.is_contiguous() for t in (decay, s_in, s0)):
        raise ValueError("ssd_scan needs contiguous operands")
    if decay.device.type == "cpu" and s_in.device == s0.device == \
            decay.device:
        return _ref.ssd_scan_ref(decay, s_in, s0)
    if decay.device.type != "cuda" or not (
            s_in.device == s0.device == decay.device):
        raise ValueError(f"ssd_scan runs on one cuda device or the cpu, got "
                         f"{decay.device}, {s_in.device}, {s0.device}")
    c, h, p, n = s_in.shape
    prefix = torch.empty_like(s_in)
    final = torch.empty_like(s0)
    fn = build.load("ssd_scan")
    build.check(fn(decay.data_ptr(), s_in.data_ptr(), s0.data_ptr(),
                   prefix.data_ptr(), final.data_ptr(), c, h, p * n,
                   torch.cuda.current_stream(decay.device).cuda_stream),
                "ssd_scan")
    ssd_scan.launches += 1
    return prefix, final


ssd_scan.launches = 0
