"""``ssd_scan``: the Mamba-2 inter-chunk state pass (kernel K5,
``csrc/ssd_scan.cu``), differentiable.  A CUDA tensor launches the
kernels -- the forward scan, and in the backward ``ssd_scan_bwd_kernel``
-- and a CPU tensor takes the plain versions of ``ref.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ref as _ref

ssd_scan_ref = _ref.ssd_scan_ref
ssd_scan_bwd_ref = _ref.ssd_scan_bwd_ref


def _device(*ts) -> torch.device:
    """The one device of ``ts`` (None entries skipped): the CPU, or a
    CUDA device; raises otherwise."""
    devs = {t.device for t in ts if t is not None}
    dev = devs.pop() if len(devs) == 1 else None
    if dev is None or dev.type not in ("cpu", "cuda"):
        got = sorted(str(t.device) for t in ts if t is not None)
        raise ValueError(f"ssd_scan runs on one cuda device or the cpu, got "
                         f"{got}")
    return dev


def _scan(decay, s_in, s0):
    if _device(decay, s_in, s0).type == "cpu":
        return _ref.ssd_scan_ref(decay, s_in, s0)
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


def ssd_scan_bwd(decay: torch.Tensor, prefix: torch.Tensor,
                 dprefix: torch.Tensor, dfinal=None):
    """The reverse recurrence (see ``ref.ssd_scan_bwd_ref``): decay (C,
    H), prefix and dprefix (C, H, P, N), dfinal (H, P, N) or None, all
    float32 and contiguous.  Returns ``(ddecay (C, H), ds_in (C, H, P,
    N), ds0 (H, P, N))``.  On CUDA ``ssd_scan_bwd_kernel`` and its
    block-sum pass, counted in ``ssd_scan_bwd.launches``."""
    ops = (decay, prefix, dprefix, dfinal)
    if prefix.dim() != 4 or dprefix.shape != prefix.shape or \
            decay.shape != prefix.shape[:2] or (
                dfinal is not None and dfinal.shape != prefix.shape[1:]):
        got = [None if t is None else tuple(t.shape) for t in ops]
        raise ValueError(f"ssd_scan_bwd takes decay (C, H), prefix and "
                         f"dprefix (C, H, P, N) and dfinal (H, P, N), got "
                         f"{got}")
    if any(t is not None and (t.dtype != torch.float32
                              or not t.is_contiguous()) for t in ops):
        raise ValueError("ssd_scan_bwd needs contiguous float32 operands")
    if _device(*ops).type == "cpu":
        return _ref.ssd_scan_bwd_ref(decay, prefix, dprefix, dfinal)
    c, h, p, n = prefix.shape
    ds_in = torch.empty_like(prefix)
    ds0 = prefix.new_empty(prefix.shape[1:])
    ddecay = torch.empty_like(decay)
    scratch = torch.empty(
        build.symbol("ssd_scan", "ssd_scan_bwd_scratch")(c, h, p * n),
        dtype=torch.float32, device=prefix.device)
    fn = build.symbol("ssd_scan", "ssd_scan_bwd_launch")
    build.check(fn(decay.data_ptr(), prefix.data_ptr(), dprefix.data_ptr(),
                   None if dfinal is None else dfinal.data_ptr(),
                   ds_in.data_ptr(), ds0.data_ptr(), ddecay.data_ptr(),
                   scratch.data_ptr(), c, h, p * n,
                   torch.cuda.current_stream(prefix.device).cuda_stream),
                "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return ddecay, ds_in, ds0


class _SsdScan(torch.autograd.Function):
    """The forward scan with ``ssd_scan_bwd`` as its backward; a missing
    cotangent of ``prefix`` or ``final`` counts as zeros."""

    @staticmethod
    def forward(ctx, decay, s_in, s0):
        prefix, final = _scan(decay, s_in, s0)
        ctx.save_for_backward(decay, prefix)
        ctx.set_materialize_grads(False)
        return prefix, final

    @staticmethod
    def backward(ctx, dprefix, dfinal):
        decay, prefix = ctx.saved_tensors
        dprefix = torch.zeros_like(prefix) if dprefix is None else \
            dprefix.contiguous()
        dfinal = None if dfinal is None else dfinal.contiguous()
        ddecay, ds_in, ds0 = ssd_scan_bwd(decay, prefix, dprefix, dfinal)
        need = ctx.needs_input_grad
        return (ddecay if need[0] else None, ds_in if need[1] else None,
                ds0 if need[2] else None)


def ssd_scan(decay: torch.Tensor, s_in: torch.Tensor, s0: torch.Tensor):
    """decay: (C, H); s_in: (C, H, P, N); s0: (H, P, N); all float32 and
    contiguous.  Returns ``(prefix (C, H, P, N), final (H, P, N))``, with
    ``prefix[c]`` the state before chunk c and
    ``state = decay[c] * state + s_in[c]`` from ``state = s0``.
    Differentiable in all three; forward launches are counted in
    ``ssd_scan.launches``, a recompute under activation checkpointing
    included."""
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
    return _SsdScan.apply(decay, s_in, s0)


ssd_scan.launches = 0
ssd_scan_bwd.launches = 0
