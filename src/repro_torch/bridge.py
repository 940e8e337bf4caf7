"""Bring the JAX package's parameter trees into the port, and back out.

The trees are nested dicts whose leaves the caller has already turned
into numpy arrays (for example ``jax.tree.map(np.asarray, tree)``):

* ``params_from_jax`` takes any such tree -- ``repro.models.lm``'s LM
  parameters with their stacked ``(n_superblocks, ...)`` leaves, or a
  CNN's -- and gives the same dicts of torch tensors on ``device``.
* ``cnn_params_from_jax`` checks a ``repro.models.cnn`` tree first: per
  weight node ``w`` (OIHW or (C_out, C_in)), ``b`` and, before BN
  folding, ``bn`` with ``scale``/``bias``/``mean``/``var``.
* ``mps_params_from_jax`` checks a search-state tree: ``gamma`` per
  group (C, |P_W|), ``delta`` (|P_X|,) and a scalar ``alpha`` per node.
* ``tree_to_numpy`` turns a port tree back into numpy arrays.

Tests use these so both packages compute with the same numbers; the port
itself never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree), device=device)


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def cnn_params_from_jax(tree, device="cpu"):
    """A ``repro.models.cnn`` parameter tree (raw or BN-folded)."""
    for name, p in tree.items():
        _require(isinstance(p, dict) and {"w", "b"} <= set(p)
                 and set(p) <= {"w", "b", "bn"},
                 f"{name}: a CNN node holds w, b and optionally bn, got "
                 f"{sorted(p) if isinstance(p, dict) else type(p)}")
        _require(np.ndim(p["w"]) in (2, 4) and np.ndim(p["b"]) == 1
                 and np.shape(p["b"])[0] == np.shape(p["w"])[0],
                 f"{name}: w {np.shape(p['w'])} / b {np.shape(p['b'])}")
        if "bn" in p:
            _require(set(p["bn"]) == {"scale", "bias", "mean", "var"},
                     f"{name}: bn holds {sorted(p['bn'])}")
    return params_from_jax(tree, device)


def mps_params_from_jax(tree, device="cpu"):
    """A search-state tree: ``{"gamma", "delta", "alpha"}``."""
    _require(set(tree) == {"gamma", "delta", "alpha"},
             f"selection parameters hold gamma, delta and alpha, got "
             f"{sorted(tree)}")
    for k, v in tree["gamma"].items():
        _require(np.ndim(v) == 2, f"gamma {k}: shape {np.shape(v)}")
    for k, v in tree["alpha"].items():
        _require(np.ndim(v) == 0, f"alpha {k}: shape {np.shape(v)}")
    return params_from_jax(tree, device)


def tree_to_numpy(tree):
    """The numpy arrays of a port tree (any device)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
