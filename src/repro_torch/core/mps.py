"""Mixed-precision search (MPS) effective tensors -- paper Sec. 4.1/4.2
(``repro.core.mps``), in torch.

Weights: per-output-channel selection over P_W (which includes 0-bit ==
structured pruning).  Activations: per-tensor selection over P_X, PACT
quantized.  The "module" state lives in plain dicts of tensors:

  mps_weight params : {'w': (..., C_out on `channel_axis`), 'gamma': (C_out, |P_W|)}
  mps_act params    : {'delta': (|P_X|,), 'alpha': ()}

``SearchCtx`` carries the sampling method, temperature, an optional
threefry key (``core/rng.py``) and the effective-weight dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import quantizers, sampling
from repro_torch.core import rng as trng
from repro_torch.distributed import sharding


@dataclasses.dataclass(frozen=True)
class SearchCtx:
    """Per-step search context threaded through all MPS sites.

    ``use_kernel``: None runs the Eq. 5 combine through kernel K4
    (``kernels/mps_combine``) when the weight is a CUDA tensor and
    through the plain quantizer stack on the CPU.  True takes K4 for any
    weight (its plain version on a CPU tensor) and raises for a weight
    K4 cannot take; False takes the plain stack, on the CPU only.  K4
    takes a float32 weight with any ``channel_axis``: the channel axis
    moved to the front, the rest flattened into rows (:func:`kernel_combine`).
    """
    method: str = sampling.SOFTMAX
    tau: torch.Tensor | float = 1.0
    rng: Optional[torch.Tensor] = None
    use_kernel: Optional[bool] = None

    def fold_rng(self, tag: int) -> Optional[torch.Tensor]:
        if self.rng is None:
            return None
        return trng.fold_in(self.rng, tag)


def _probs(logits: torch.Tensor, ctx: SearchCtx, tag: int) -> torch.Tensor:
    # only the Gumbel sampler draws: the key is folded for it alone (the
    # reference folds it for every site and XLA drops the unused ones;
    # eagerly each fold is ~150 small integer launches)
    rng = ctx.fold_rng(tag) if ctx.method == sampling.GUMBEL else None
    return sampling.sample(logits, ctx.method, ctx.tau, rng)


def gamma_probs(gamma: torch.Tensor, ctx: SearchCtx, tag: int = 0
                ) -> torch.Tensor:
    """(C_out, |P_W|) probability rows for the weight selection params."""
    return _probs(gamma, ctx, tag)


def delta_probs(delta: torch.Tensor, ctx: SearchCtx, tag: int = 0
                ) -> torch.Tensor:
    """(|P_X|,) probability vector for the activation selection params."""
    return _probs(delta, ctx, tag)


def effective_weight(w: torch.Tensor, gamma: torch.Tensor,
                     precisions: tuple[int, ...], ctx: SearchCtx,
                     channel_axis: int = 0, tag: int = 0,
                     absmax_group=None, probs_group=None,
                     rows=None) -> torch.Tensor:
    """Paper Eq. 5: W_hat = sum_p gamma_hat[:, p] * Q_p(W), for ``w``
    whole or a rank's shard of it (``distributed.sharding``).

    ``absmax_group``: the process group over which ``w``'s other axes
    (its C_in) are split.  Each rank reduces its own per-channel absmax,
    the all-reduce MAX gives the whole weight's, and the combine takes
    it as given (K4's ``absmax_in``, or the plain quantizer stack's
    ``absmax``).  ``probs_group``: the selection probabilities enter
    through the copy into it, so their Eq. 5 gradient, partial on each
    rank, is summed over it.  ``rows``: ``(start, count)`` of the
    channels this shard holds, the probabilities' rows it takes (after
    the copy)."""
    probs = gamma_probs(gamma, ctx, tag)  # (C, |P|)
    if probs.shape[0] == 1 and w.shape[channel_axis] != 1:
        # layer-wise MPS (EdMIPS-style): one selection row for the whole
        # layer, broadcast over channels (gradients sum over channels)
        probs = probs.expand(w.shape[channel_axis], probs.shape[1])
    probs = sharding.copy_to(probs, probs_group)
    if rows is not None:
        probs = probs.narrow(0, *rows)
    absmax = None
    if absmax_group is not None:
        axis = channel_axis % w.ndim
        absmax = sharding.all_reduce_max(torch.amax(
            w.detach().abs(), dim=tuple(i for i in range(w.ndim)
                                        if i != axis)), absmax_group)
    use_kernel = w.is_cuda if ctx.use_kernel is None else ctx.use_kernel
    if use_kernel:
        return kernel_combine(w, probs, precisions, channel_axis, absmax)
    if w.is_cuda:
        raise ValueError("SearchCtx(use_kernel=False) runs the plain "
                         "quantizer stack, which takes CPU weights only; a "
                         "CUDA weight goes through kernel K4")
    if absmax is not None:
        shape = [1] * w.ndim
        shape[channel_axis] = w.shape[channel_axis]
        absmax = absmax.reshape(shape)
    qs = quantizers.quantize_weights_multi(w, precisions, channel_axis,
                                           absmax)
    # reshape probs so that the channel dim broadcasts on `channel_axis`
    shape = [len(precisions)] + [1] * w.ndim
    shape[1 + channel_axis] = w.shape[channel_axis]
    probs_b = torch.movedim(probs, -1, 0).reshape(shape)
    return torch.sum(probs_b * qs, dim=0)


def kernel_combine(w: torch.Tensor, probs: torch.Tensor,
                   precisions: tuple[int, ...], channel_axis: int = 0,
                   absmax: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 5 through kernel K4 for a weight whose output channels lie on
    ``channel_axis``: the axis moved to the front and the rest flattened
    into rows of a contiguous ``(C_out, -1)`` copy (a transposing copy
    unless ``channel_axis`` is 0), combined by ``mps_combine``, and
    handed back as a view with the weight's layout.  The backward's
    upstream gradient takes the same transposing copy into rows, and dW
    comes back through the view.  Both copies run inside the profiler
    range ``COPY_RANGES[w.ndim == 3]`` (whose device-side row repeats
    their kernels' time).  ``absmax`` (C_out,), when given, is K4's
    ``absmax_in``.  Raises for a weight K4 cannot take."""
    from repro_torch.kernels.mps_combine import ops as mps_ops
    if w.dtype != torch.float32 or probs.dtype != torch.float32:
        raise TypeError(f"kernel K4 takes float32 weights and "
                        f"probabilities, got {w.dtype} and {probs.dtype}")
    axis = channel_axis % w.ndim
    if axis == 0:
        flat = w.reshape(w.shape[0], -1).contiguous()
        out = mps_ops.mps_combine(flat, probs.contiguous(), precisions,
                                  absmax)
        return out.reshape(w.shape)
    rows = torch.movedim(w, axis, 0)
    label = COPY_RANGES[w.ndim == 3]
    with torch.profiler.record_function(label):
        flat = rows.reshape(rows.shape[0], -1).contiguous()
    out = mps_ops.mps_combine(flat, probs.contiguous(), precisions, absmax)
    return _FromRows.apply(out, tuple(rows.shape), axis, label)


# profiler ranges around kernel_combine's transposing copies into rows, of
# a 2-D weight and of an expert bank
COPY_RANGES = {False: "K4 transposing copy", True: "K4 bank transposing copy"}


class _FromRows(torch.autograd.Function):
    """K4's rows ``(C_out, -1)`` seen in the weight's layout (a view);
    the backward takes the upstream gradient's transposing copy into rows
    inside the profiler range ``label``."""

    @staticmethod
    def forward(ctx, out, shape, axis, label):
        ctx.shape, ctx.axis, ctx.label = shape, axis, label
        return torch.movedim(out.reshape(shape), 0, axis)

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function(ctx.label):
            g = torch.movedim(g, ctx.axis, 0).reshape(ctx.shape[0], -1)
            return g.contiguous(), None, None, None


def effective_activation(x: torch.Tensor, delta: torch.Tensor,
                         alpha: torch.Tensor, precisions: tuple[int, ...],
                         ctx: SearchCtx, tag: int = 0) -> torch.Tensor:
    """Paper Eq. 4: X_hat = sum_p delta_hat[p] * Q_p(X) (PACT variants)."""
    probs = delta_probs(delta, ctx, tag)  # (|Px|,)
    qs = quantizers.quantize_acts_multi(x, alpha, precisions)
    probs_b = probs.reshape((len(precisions),) + (1,) * x.ndim)
    return torch.sum(probs_b * qs, dim=0)


def init_mps_weight(c_out: int, precisions: tuple[int, ...],
                    device=None) -> torch.Tensor:
    """Per-channel gamma logits, paper Eq. 13 init."""
    return sampling.init_selection_logits(precisions, (c_out,), device)


def init_mps_act(precisions: tuple[int, ...], alpha0: float = 6.0,
                 device=None):
    """(delta logits, PACT alpha) initial values."""
    return (sampling.init_selection_logits(precisions, (), device),
            torch.tensor(alpha0, dtype=torch.float32, device=device))


def _nonzero(precisions, like):
    return torch.tensor([float(p != 0) for p in precisions],
                        dtype=like.dtype, device=like.device)


def rescale_weights_for_search(w: torch.Tensor, gamma: torch.Tensor,
                               precisions: tuple[int, ...], ctx: SearchCtx,
                               channel_axis: int = 0) -> torch.Tensor:
    """Paper Eq. 12 weight rescaling at the start of the search phase:
    each channel divided by its non-zero-bit probability mass, so the
    effective tensor keeps the warmup magnitude."""
    probs = gamma_probs(gamma, ctx)  # (C, |P|)
    mass = torch.sum(probs * _nonzero(precisions, w), dim=-1)  # (C,)
    mass = torch.clamp_min(mass, 1e-3)
    if mass.shape[0] == 1:          # layer-wise gamma
        mass = mass.expand(w.shape[channel_axis])
    shape = [1] * w.ndim
    shape[channel_axis] = w.shape[channel_axis]
    return w / mass.reshape(shape)


def discretize_gamma(gamma: torch.Tensor, precisions: tuple[int, ...]
                     ) -> torch.Tensor:
    """Paper Eq. 8: per-channel argmax precision assignment (int32)."""
    idx = torch.argmax(gamma, dim=-1)
    return torch.tensor(precisions, dtype=torch.int32,
                        device=gamma.device)[idx]


def discretize_delta(delta: torch.Tensor, precisions: tuple[int, ...]
                     ) -> int:
    """Paper Eq. 7: per-tensor argmax precision assignment."""
    return int(precisions[int(torch.argmax(delta))])


def expected_bits(gamma: torch.Tensor, precisions: tuple[int, ...],
                  ctx: SearchCtx) -> torch.Tensor:
    """Per-channel expected bit-width <gamma_hat, P_W>."""
    probs = gamma_probs(gamma, ctx)
    return probs @ torch.tensor(precisions, dtype=probs.dtype,
                                device=probs.device)


def keep_probability(gamma: torch.Tensor, precisions: tuple[int, ...],
                     ctx: SearchCtx) -> torch.Tensor:
    """Per-channel probability of NOT being pruned (1 - gamma_hat[:, p0])."""
    probs = gamma_probs(gamma, ctx)
    return probs @ _nonzero(precisions, probs)
