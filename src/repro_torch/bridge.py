"""Bring the JAX package's parameter trees into the port, and back out.

The trees are nested dicts whose leaves the caller has already turned
into numpy arrays (for example ``jax.tree.map(np.asarray, tree)``):

* ``params_from_jax`` takes any such tree -- ``repro.models.lm``'s LM
  parameters with their stacked ``(n_superblocks, ...)`` leaves, or a
  CNN's -- and gives the same dicts of torch tensors on ``device``.
* ``lm_params_from_jax`` checks an LM tree first: ``embed``, ``blocks``,
  ``final_norm`` and ``lm_head``; every ``blocks`` leaf stacked on one
  leading ``n_superblocks`` axis (an enc-dec tree's ``enc_blocks`` on
  the encoder's own, beside ``enc_norm``); given the ``cfg``, each slot
  of the super-block as its pattern has it (a hybrid's Mamba-2 layers
  with ``norm2`` and an ``ffn``, its banks on the odd slots only); an MoE
  layer's expert banks 4-D,
  ``(n_superblocks, E, K, N)`` with E its router's width; and, where a
  projection carries one, ``gamma (n_superblocks, C_out, |P_W|)`` (an
  expert bank's one gamma, shared by its experts, on the bank's last
  axis).
* ``cnn_params_from_jax`` checks a ``repro.models.cnn`` tree first: per
  weight node ``w`` (OIHW or (C_out, C_in)), ``b`` and, before BN
  folding, ``bn`` with ``scale``/``bias``/``mean``/``var``.
* ``mps_params_from_jax`` checks a search-state tree: ``gamma`` per
  group (C, |P_W|), ``delta`` (|P_X|,) and a scalar ``alpha`` per node.
* ``opt_state_from_jax`` checks an optimizer state of a parameter tree
  against that tree: ``adam``'s ``{"m", "v"}`` (each the tree's shapes)
  or ``adam_int8``'s ``{"mq", "ms", "vq", "vs"}`` per leaf (int8 codes
  of the leaf's shape, float32 scales of its shape less the last axis)
  -- an MoE or hybrid search tree's bank gammas and banks among them.
* ``tree_to_numpy`` turns a port tree back into numpy arrays (a bf16
  leaf as ml_dtypes' bfloat16, as the JAX package holds it).

Tests use these so both packages compute with the same numbers; the port
itself never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    a = np.array(tree)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device)


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _leaf_shapes(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_shapes(v, f"{path}.{k}" if path else k)
    else:
        yield path, np.shape(tree)


def _check_gammas(tree, nsb, n_pw, path):
    if not isinstance(tree, dict):
        return
    if "gamma" in tree:
        w, g = np.shape(tree["w"]), np.shape(tree["gamma"])
        _require(len(g) == 3 and g[:2] == (nsb, w[-1])
                 and (n_pw is None or g[2] == n_pw),
                 f"{path}.gamma: shape {g} for w {w}, want (n_superblocks "
                 f"{nsb}, C_out {w[-1]}, |P_W|"
                 f"{'' if n_pw is None else ' ' + str(n_pw)})")
    for k, v in tree.items():
        _check_gammas(v, nsb, n_pw, f"{path}.{k}")


def _check_banks(tree, path):
    if not isinstance(tree, dict):
        return
    if "router" in tree:
        e = np.shape(tree["router"]["w"])[-1]
        for name in ("w_gate", "w_up", "w_down"):
            w = np.shape(tree[name]["w"])
            _require(len(w) == 4 and w[1] == e,
                     f"{path}.{name}: expert bank of shape {w}, want "
                     f"(n_superblocks, E {e}, K, N)")
    for k, v in tree.items():
        _check_banks(v, f"{path}.{k}")


def _check_pattern(tree, pattern, key: str):
    """Each slot ``l<i>`` holds what the super-block pattern gives it: its
    mixer (``mixer.in_x`` for Mamba-2, ``mixer.wq`` for attention), and
    ``norm2`` with an ``ffn`` wherever the slot has one (the hybrid's
    Mamba-2 layers too), expert banks with a router on the MoE slots
    only (the hybrid's odd ones)."""
    _require(sorted(tree) == sorted(f"l{i}" for i in range(len(pattern))),
             f"{key}: slots {sorted(tree)}, the pattern has "
             f"{len(pattern)}")
    for i, spec in enumerate(pattern):
        layer, where = tree[f"l{i}"], f"{key}.l{i}"
        mixer = "in_x" if spec.mixer == "mamba" else "wq"
        _require(mixer in layer.get("mixer", {}),
                 f"{where}: a {spec.mixer} slot, but its mixer holds "
                 f"{sorted(layer.get('mixer', {}))}")
        has_ffn = spec.ffn is not None
        _require({"norm2", "ffn"} <= set(layer) if has_ffn
                 else not {"norm2", "ffn"} & set(layer),
                 f"{where}: a {spec.mixer} slot "
                 f"{'with' if has_ffn else 'without'} an FFN (norm2 and "
                 f"ffn), holds {sorted(layer)}")
        if has_ffn:
            _require(("router" in layer["ffn"]) == (spec.ffn == "moe"),
                     f"{where}.ffn: the pattern gives this slot a "
                     f"{spec.ffn} FFN, the tree holds {sorted(layer['ffn'])}")


def _stack_count(tree, key: str) -> int:
    shapes = list(_leaf_shapes(tree, key))
    n = {s[0] if s else None for _, s in shapes}
    _require(len(n) == 1 and None not in n,
             f"{key} leaves must share one leading super-block axis, got "
             f"{sorted((p, s) for p, s in shapes)[:4]}...")
    return n.pop()


def lm_params_from_jax(tree, device="cpu", cfg=None):
    """A ``repro.models.lm`` parameter tree (``init_params(...,
    mps_on=...)``); ``cfg`` (the port's ``ArchConfig``) also fixes the
    super-block counts and |P_W|.  An enc-dec tree's ``enc_blocks`` are
    stacked on the encoder's own super-block count, beside ``enc_norm``."""
    _require({"embed", "blocks", "final_norm", "lm_head"} <= set(tree),
             f"an LM tree holds embed, blocks, final_norm and lm_head, got "
             f"{sorted(tree)}")
    _require(("enc_blocks" in tree) == ("enc_norm" in tree),
             f"an enc-dec tree holds enc_blocks and enc_norm, got "
             f"{sorted(tree)}")
    stacks = [k for k in ("blocks", "enc_blocks") if k in tree]
    counts = {k: _stack_count(tree[k], k) for k in stacks}
    n_pw = None
    if cfg is not None:
        from repro_torch.models import lm
        want = {"blocks": lm.n_superblocks(cfg)}
        if cfg.is_encdec:
            want["enc_blocks"] = lm.n_enc_superblocks(cfg)
        _require(sorted(want) == sorted(counts),
                 f"{cfg.name} has {sorted(want)}, the tree {sorted(counts)}")
        for k, n in want.items():
            _require(counts[k] == n, f"{k}: {counts[k]} super-blocks, "
                                     f"{cfg.name} has {n}")
        _check_pattern(tree["blocks"], lm.block_pattern(cfg), "blocks")
        if cfg.is_encdec:
            _check_pattern(tree["enc_blocks"], lm.enc_pattern(cfg),
                           "enc_blocks")
        n_pw = len(cfg.mps_precisions)
    for k in stacks:
        _check_gammas(tree[k], counts[k], n_pw, k)
        _check_banks(tree[k], k)
    return params_from_jax(tree, device)


def lm_shard_from_jax(tree, cfg, device="cpu"):
    """This rank's port tree from a whole ``repro.models.lm`` tree under
    the installed mesh (``distributed.sharding.use_mesh``): the tree
    carried by :func:`lm_params_from_jax`, then cut by
    ``launch.steps.shard_tree`` along ``lm.logical_axes`` (every axis
    the installed rules map); a tree with gammas takes the search's
    axes."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    whole = lm_params_from_jax(tree, device, cfg)
    mps_on = any(p.endswith("gamma") for p, _ in _leaf_shapes(whole))
    return steps.shard_tree(whole, lm.logical_axes(cfg, mps_on))


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


_INT8_STATE = ("mq", "ms", "vq", "vs")


def _check_int8_state(state, params, path):
    if isinstance(params, dict):
        _require(isinstance(state, dict) and sorted(state) == sorted(params),
                 f"{path}: the state holds {sorted(state)}, the parameters "
                 f"{sorted(params)}")
        for k in params:
            _check_int8_state(state[k], params[k], f"{path}.{k}")
        return
    shape = tuple(np.shape(params))
    _require(isinstance(state, dict) and sorted(state) == sorted(
        _INT8_STATE), f"{path}: an adam_int8 leaf holds {_INT8_STATE}")
    for q, sc in (("mq", "ms"), ("vq", "vs")):
        _require(np.shape(state[q]) == shape and np.asarray(
            state[q]).dtype == np.int8 and np.shape(state[sc]) == shape[:-1],
            f"{path}.{q}/{sc}: shapes {np.shape(state[q])} / "
            f"{np.shape(state[sc])} for a parameter of {shape}, want int8 "
            f"{shape} and {shape[:-1]}")


def opt_state_from_jax(state, params, device="cpu"):
    """A ``repro.optim.optimizers`` state for the parameter tree
    ``params`` (either package's tree, any leaves with a shape):
    ``adam``'s ``{"m", "v"}`` or ``adam_int8``'s per-leaf codes and
    scales, checked against ``params``, then carried as
    :func:`params_from_jax` carries a tree."""
    if isinstance(state, dict) and sorted(state) == ["m", "v"]:
        want = dict(_leaf_shapes(params))
        for k in ("m", "v"):
            got = dict(_leaf_shapes(state[k]))
            odd = sorted(set(got.items()) ^ set(want.items()))
            _require(not odd, f"adam state {k}: shapes differ from the "
                              f"parameters' at {odd[:4]}")
    else:
        _check_int8_state(state, params, "state")
    return params_from_jax(state, device)


def tree_to_numpy(tree):
    """The numpy arrays of a port tree (any device)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:      # numpy has no bfloat16: ml_dtypes'
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
