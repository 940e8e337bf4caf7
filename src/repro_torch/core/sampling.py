"""Bit-width selection parameter sampling (paper Eq. 3), in torch
(``repro.core.sampling``).

Three sampling methods over the selection logits:
  * SM   -- softmax with temperature tau
  * AM   -- argmax (the tau -> 0 limit); forward is a hard one-hot,
            backward uses the tau-softmax surrogate (straight-through)
  * HGSM -- hard Gumbel-softmax: Gumbel-perturbed argmax forward,
            soft Gumbel-softmax backward; the Gumbel noise is the JAX
            package's, drawn by ``core/rng.py``

``logits`` may be (|P|,) for a per-layer activation assignment (delta)
or (C_out, |P|) for per-channel weight assignment (gamma); sampling is
applied along the last axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import rng as trng

SOFTMAX = "softmax"
ARGMAX = "argmax"
GUMBEL = "gumbel"
SAMPLERS = (SOFTMAX, ARGMAX, GUMBEL)


def _hard_from_soft(soft: torch.Tensor) -> torch.Tensor:
    """One-hot of the soft distribution's argmax, with soft gradients."""
    hard = F.one_hot(torch.argmax(soft, dim=-1), soft.shape[-1]).to(
        soft.dtype)
    return soft + (hard - soft).detach()


def sample(logits: torch.Tensor, method: str, tau,
           rng: torch.Tensor | None = None) -> torch.Tensor:
    """Return a probability vector (rows sum to 1) over the precision
    set.  ``rng`` is a threefry key (``core/rng.py``)."""
    tau = torch.clamp_min(torch.as_tensor(tau, dtype=logits.dtype,
                                          device=logits.device), 1e-4)
    if method == SOFTMAX:
        return torch.softmax(logits / tau, dim=-1)
    if method == ARGMAX:
        return _hard_from_soft(torch.softmax(logits / tau, dim=-1))
    if method == GUMBEL:
        if rng is None:
            raise ValueError("gumbel sampling requires an rng key")
        g = trng.gumbel(rng.to(logits.device), logits.shape)
        return _hard_from_soft(torch.softmax((logits + g) / tau, dim=-1))
    raise ValueError(f"unknown sampling method {method!r}")


def temperature_schedule(initial: float, decay: float):
    """Per-epoch exponential temperature decay: tau_e = initial * decay**e.

    The paper uses decay = exp(-0.045) for CIFAR-10/GSC and 0.638 for
    Tiny ImageNet (fewer epochs, same final temperature).
    """
    def tau_at(epoch) -> torch.Tensor:
        return torch.tensor(initial, dtype=torch.float32) * torch.pow(
            torch.tensor(decay, dtype=torch.float32), epoch)
    return tau_at


def init_selection_logits(precisions: tuple[int, ...],
                          leading_shape: tuple[int, ...] = (),
                          device=None) -> torch.Tensor:
    """Paper Eq. 13: logits proportional to the precision, gamma_p =
    p/max(P).  Higher precisions start more likely; 0-bit (pruning)
    starts least likely, which avoids early gradient-flow interruption.
    """
    pmax = float(max(precisions))
    base = torch.tensor([p / pmax for p in precisions], dtype=torch.float32,
                        device=device)
    return base.expand(tuple(leading_shape) + (len(precisions),)).clone()
