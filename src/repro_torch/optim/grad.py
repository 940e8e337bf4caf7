"""Gradient utilities (``repro.optim.grad``) over nested dicts of tensors:
clipping, micro-batch accumulation, int8 error-feedback compression.

Divisions by a constant follow the reference under ``jax.jit``, where
XLA multiplies by the constant's float32 reciprocal
(``core.quantizers.recip``): ``compress_int8``'s ``max / 127.0`` is
``max * f32(1/127)``.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantizers
from repro_torch.optim.optimizers import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(tree, max_norm: float, norm=None):
    """``(tree * min(1, max_norm / max(norm, 1e-12)), norm)``; each leaf
    keeps its dtype.  ``norm`` defaults to :func:`global_norm` of the
    tree (a sharded tree's caller passes the norm over all ranks)."""
    if norm is None:
        norm = global_norm(tree)
    cap = torch.tensor(max_norm, dtype=torch.float32, device=norm.device)
    scale = torch.clamp(cap / torch.clamp_min(norm, 1e-12), max=1.0)
    return tree_map(lambda x: (x * scale).to(x.dtype), tree), norm


def value_and_grad(loss_fn, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)`` with respect to
    every leaf of ``params`` (zeros for a leaf the loss does not use);
    the loss comes back detached."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = loss_fn(leaves, batch)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, grads))
    return loss.detach(), tree_map(lambda _: next(it), params)


def accumulate_grads(loss_fn, params, batches):
    """Average ``loss_fn(params, batch)`` and its gradients over the
    micro-batches stacked on the leading axis of ``batches``, summing in
    the parameter dtype with one micro-batch's graph live at a time.
    Returns (grads, loss)."""
    n = tree_leaves(batches)[0].shape[0]
    grads, total = tree_map(torch.zeros_like, params), 0.0
    for i in range(n):
        loss, g = value_and_grad(loss_fn, params,
                                 tree_map(lambda x: x[i], batches))
        grads = tree_map(lambda a, b: a + b.to(a.dtype), grads, g)
        total = total + loss
    return tree_map(lambda g: g / n, grads), total / n


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression
# ---------------------------------------------------------------------------

def compress_int8(g: torch.Tensor):
    """Per-tensor symmetric int8 quantization.  Returns (q, scale)."""
    scale = torch.clamp_min(torch.amax(torch.abs(g)), 1e-12) * \
        quantizers.recip(127.0, g)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_tree(grads, error):
    """Error-feedback compression: ``q = Q(g + e)``, ``new_e = (g + e) -
    dq(q)``.  Returns the tree of ``(q, scale)`` pairs and the new
    residual tree, carried across steps so the quantization noise is
    unbiased over time."""
    def leaf(g, e):
        corrected = g.float() + e
        q, s = compress_int8(corrected)
        # one rounding: XLA's CPU backend fuses ``c - q * s`` into an FMA
        # (the float64 product of two float32 values is exact)
        err = (corrected.double() - q.double() * s.double()).float()
        return (q, s), err

    pairs = tree_map(leaf, grads, error)
    return (tree_map(lambda p: p[0], pairs),
            tree_map(lambda p: p[1], pairs))


def ef_decompress_tree(comp):
    return tree_map(lambda qs: decompress_int8(*qs), comp)


def init_error_tree(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
