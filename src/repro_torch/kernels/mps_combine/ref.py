"""Plain PyTorch version of the ``mps_combine`` kernel (K4): the same
arithmetic as ``csrc/mps_combine.cu``, accumulated in the same
precision order, so the kernel's output equals it bit for bit.

It is written with the search's quantizer (``core.quantizers``), whose
straight-through rounding and tie-splitting clip make autograd through
this function the gradient that ``ops.mps_combine``'s backward computes
in closed form.  The CPU path of ``ops`` runs it; on the card it serves
only as the comparison."""
from __future__ import annotations

import torch

from repro_torch.core import quantizers


def mps_combine_ref(w: torch.Tensor, probs: torch.Tensor,
                    precisions: tuple[int, ...],
                    absmax: torch.Tensor | None = None) -> torch.Tensor:
    """w: (M, K); probs: (M, |P|) rows summing to 1.  Returns
    ``sum_p probs[:, p] * Q_p(w)`` (M, K), the 0-bit term skipped;
    ``absmax`` (M,), when given, replaces each row's ``max |w|``."""
    acc = torch.zeros_like(w)
    given = None if absmax is None else absmax.reshape(-1, 1)
    for idx, bits in enumerate(precisions):
        if bits == 0:
            continue
        q = quantizers.quantize_weights_symmetric(w, bits, 0, absmax=given)
        acc = acc + probs[:, idx:idx + 1] * q
    return acc
