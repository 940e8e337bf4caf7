"""Bring the JAX package's parameters into the port.

``params_from_jax`` takes the tree ``repro.models.lm.init_params``
returns, with its leaves already turned into numpy arrays (for example
``jax.tree.map(np.asarray, params)``), and gives the port's tree: the
same nested dicts and the same stacked ``(n_superblocks, ...)`` leaves,
as torch tensors on ``device``.  Tests use it so both packages compute
with the same weights; the port itself never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree), device=device)
