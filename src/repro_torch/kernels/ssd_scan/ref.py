"""Plain PyTorch version of the ``ssd_scan`` kernel (K5): the Mamba-2
inter-chunk state recurrence, one chunk at a time, with the multiply and
the add as separate IEEE-rounded operations in that order -- the
arithmetic of ``csrc/ssd_scan.cu``, so the kernel equals it bit for bit.
The CPU path of ``ops`` runs it; on the card it serves only as the
comparison."""
from __future__ import annotations

import torch


def ssd_scan_ref(decay: torch.Tensor, s_in: torch.Tensor,
                 s0: torch.Tensor):
    """decay: (C, H); s_in: (C, H, P, N); s0: (H, P, N).  Returns
    ``(prefix (C, H, P, N), final (H, P, N))``: ``prefix[c]`` is the state
    before chunk c and ``state = decay[c] * state + s_in[c]``."""
    prefix = torch.empty_like(s_in)
    state = s0.clone()
    for c in range(s_in.shape[0]):
        prefix[c] = state
        state = decay[c][:, None, None] * state + s_in[c]
    return prefix, state
