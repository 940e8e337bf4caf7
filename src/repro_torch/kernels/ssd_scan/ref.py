"""Plain PyTorch versions of the ``ssd_scan`` kernels (K5): the Mamba-2
inter-chunk state recurrence and its reverse, one chunk at a time, with
each multiply and add a separate IEEE-rounded operation in that order --
the arithmetic of ``csrc/ssd_scan.cu``, so the kernels equal them bit for
bit (the backward's ``ddecay`` sums excepted, see
:func:`ssd_scan_bwd_ref`).  The CPU path of ``ops`` runs them; on the
card they serve only as the comparison."""
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


def ssd_scan_bwd_ref(decay: torch.Tensor, prefix: torch.Tensor,
                     dprefix: torch.Tensor, dfinal=None):
    """The reverse recurrence of :func:`ssd_scan_ref`.  decay (C, H);
    prefix, dprefix (C, H, P, N); dfinal (H, P, N) or None (``final``
    unused: zeros).  From ``G = dfinal``, for c = C-1 .. 0::

        ds_in[c]     = G
        ddecay[c, h] = sum over (p, n) of G * prefix[c]
        G            = dprefix[c] + decay[c] * G

    and ``ds0 = G``.  Returns ``(ddecay (C, H), ds_in (C, H, P, N), ds0
    (H, P, N))``.  ``ds_in`` and ``ds0`` are the kernel's bits; ``ddecay``
    sums its P * N products in torch's order, another than the kernel's
    tree, so the two differ by at most ``2 * P * N * 2**-24 * sum |G *
    prefix|`` (each within ``P * N * 2**-24`` of that sum's size of the
    exact one)."""
    c_n = prefix.shape[0]
    g = torch.zeros_like(prefix[0]) if dfinal is None else dfinal.clone()
    ds_in = torch.empty_like(prefix)
    ddecay = torch.empty_like(decay)
    for c in range(c_n - 1, -1, -1):
        ds_in[c] = g
        ddecay[c] = (g * prefix[c]).sum(dim=(1, 2))
        g = dprefix[c] + decay[c][:, None, None] * g
    return ddecay, ds_in, g
