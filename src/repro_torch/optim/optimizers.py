"""Functional optimizers (optax-style init/update pairs) over nested dicts
of tensors (``repro.optim.optimizers``): ``update`` returns new tensors
and a new state, as the JAX package's does; nothing is updated in place.

``adam_int8`` keeps its moments int8 with the parameter's shape.
``state_logical_axes`` gives the state's logical axes
(``distributed.sharding``): a rank updates its shard of a split leaf
with the same per-row blocks as the whole; where a leaf's last axis is
split (``update``'s ``axes``: the parameters' logical axes), a row's
int8 scale is the maximum over the ranks that hold its parts, as the
reference's row maximum is.  ``sgd`` and ``adam`` ignore ``axes``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import quantizers


class Optimizer(NamedTuple):
    init: Callable
    # (grads, state, params, step, axes=None) -> (new_params, state)
    update: Callable


def tree_map(f, *trees):
    """Map ``f`` over the leaves of nested dicts of identical structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in trees[0]}
    return f(*trees)


def tree_map_with_path(f, tree, path=()):
    """``tree_map`` whose ``f`` also gets the leaf's tuple of keys."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(f, v, path + (k,))
                for k, v in tree.items()}
    return f(path, tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _f32(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def sgd(lr: Callable | float, momentum: float = 0.0,
        weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def update(grads, state, params, step, axes=None):
        lr_t = lr_fn(step)
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads,
                             params)
        if momentum == 0.0:
            new_params = tree_map(lambda p, g: p - lr_t * g, params, grads)
            return new_params, state
        new_state = tree_map(lambda m, g: momentum * m + g, state, grads)
        new_params = tree_map(lambda p, m: p - lr_t * m, params, new_state)
        return new_params, new_state

    return Optimizer(init, update)


def adam(lr: Callable | float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """AdamW when weight_decay > 0 (decoupled decay), the JAX package's
    update and bias-correction form: ``p - lr * ((m / bc1) /
    (sqrt(v / bc2) + eps) + wd * p)`` with ``bc = 1 - b ** (step + 1)``
    in float32."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params, step, axes=None):
        t = step + 1
        lr_t = lr_fn(step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"],
                     grads)

        def step_fn(p, m_, v_):
            bc1 = 1 - _f32(b1, p) ** t
            bc2 = 1 - _f32(b2, p) ** t
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p
            return p - lr_t * upd

        new_params = tree_map(step_fn, params, m, v)
        return new_params, {"m": m, "v": v}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# int8 quantized optimizer state
# ---------------------------------------------------------------------------
# Moments are stored int8 with the parameter's shape plus one f32 scale
# per last-axis row (shape = param.shape[:-1]); v is quantized in
# sqrt-space for relative precision.  ``/ 127.0`` is the multiply by
# f32(1/127) that the reference computes under ``jax.jit``.


def _row_group(axes):
    """The process group over which the last axis of a parameter with
    logical axes ``axes`` is split (None when whole or not given)."""
    if not axes:
        return None
    from repro_torch.distributed import sharding
    dims = sharding.dim_axes(*axes)
    return sharding.group_of(dims[-1]) if dims else None


def _q8_row(x: torch.Tensor, group=None):
    inv = quantizers.recip(127.0, x)
    if x.dim() == 0:
        scale = torch.clamp_min(torch.abs(x), 1e-12) * inv
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return q, scale.float()
    top = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    if group is not None:
        from repro_torch.distributed import sharding
        top = sharding.all_reduce_max(top, group)
    scale = top * inv
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0].float()


def _dq8_row(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if q.dim() == 0:
        return q.float() * scale
    return q.float() * scale[..., None]


# a leaf larger than this is updated in blocks of whole last-axis rows:
# each row has its own int8 scales and every other step is elementwise,
# so the blocks give the whole leaf's bits, while the update's float32
# temporaries stay at a block's size (an arctic expert bank is 1.1 B
# values: ~4.5 GB for each float32 temporary of the whole leaf)
UPDATE_BLOCK = 1 << 26


def adam_int8(lr: Callable | float, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam with int8 row-quantized first/second moments (2 bytes+/param);
    each leaf's state is ``{"mq", "ms", "vq", "vs"}``.  A leaf of more
    than ``UPDATE_BLOCK`` values is updated a block of rows at a time
    (the same bits)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        def leaf(p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            mq, ms = _q8_row(z)
            vq, vs = _q8_row(z)
            return {"mq": mq, "ms": ms, "vq": vq, "vs": vs}
        return tree_map(leaf, params)

    @torch.no_grad()
    def update(grads, state, params, step, axes=None):
        t = step + 1
        lr_t = lr_fn(step)

        def leaf(p, g, s, group):
            bc1 = 1 - _f32(b1, p) ** t
            bc2 = 1 - _f32(b2, p) ** t
            g = g.float()
            m = _dq8_row(s["mq"], s["ms"])
            vsqrt = _dq8_row(s["vq"], s["vs"])
            v = vsqrt * vsqrt
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            new_p = (p.float() - lr_t * upd).to(p.dtype)
            mq, ms = _q8_row(m, group)
            vq, vs = _q8_row(torch.sqrt(v), group)
            return new_p, {"mq": mq, "ms": ms, "vq": vq, "vs": vs}

        def blocked(p, g, s, a):
            group = _row_group(a)
            if p.dim() < 2 or p.numel() <= UPDATE_BLOCK:
                return leaf(p, g, s, group)
            n = p.shape[-1]
            rows = max(1, UPDATE_BLOCK // n)
            flat = [t.reshape(-1, n) for t in (p, g, s["mq"], s["vq"])]
            scales = [s["ms"].reshape(-1), s["vs"].reshape(-1)]
            out = [torch.empty_like(t) for t in (flat[0], flat[2], flat[3])]
            out_s = [torch.empty_like(t) for t in scales]
            for i in range(0, flat[0].shape[0], rows):
                r = slice(i, i + rows)
                new_p, st = leaf(flat[0][r], flat[1][r], {
                    "mq": flat[2][r], "ms": scales[0][r],
                    "vq": flat[3][r], "vs": scales[1][r]}, group)
                out[0][r], out[1][r], out[2][r] = new_p, st["mq"], st["vq"]
                out_s[0][r], out_s[1][r] = st["ms"], st["vs"]
            return out[0].reshape(p.shape), {
                "mq": out[1].reshape(p.shape), "ms": out_s[0].reshape(
                    s["ms"].shape), "vq": out[2].reshape(p.shape),
                "vs": out_s[1].reshape(s["vs"].shape)}

        def walk(p, g, s, a):  # the state: a dict per parameter leaf
            if not isinstance(p, dict):
                return blocked(p, g, s, a)
            outs = {k: walk(p[k], g[k], s[k], None if a is None else a[k])
                    for k in p}
            return ({k: o[0] for k, o in outs.items()},
                    {k: o[1] for k, o in outs.items()})

        return walk(params, grads, state, axes)

    return Optimizer(init, update)


def state_logical_axes(opt_name: str, params_logical):
    """Logical-axis tree matching the optimizer state structure
    (``optimizers.state_logical_axes``).  ``params_logical`` leaves are
    tuples of logical axis names (or None); ``adam_int8``'s codes take
    the leaf's axes, its row scales all but the last; ``sgd`` gives
    ``()``, as the reference does."""
    def minus_last(axes):
        return tuple(axes[:-1]) if len(axes) > 0 else ()

    def per_leaf(f, tree):
        if isinstance(tree, dict):
            return {k: per_leaf(f, v) for k, v in tree.items()}
        return f(tree)

    if opt_name == "adam":
        return {"m": params_logical, "v": params_logical}
    if opt_name == "adam_int8":
        return per_leaf(lambda a: {"mq": a, "ms": minus_last(a), "vq": a,
                                   "vs": minus_last(a)}, params_logical)
    if opt_name == "sgd":
        return ()
    raise ValueError(opt_name)


def make_optimizer(name: str, lr) -> Optimizer:
    if name == "adam":
        return adam(lr)
    if name == "adam_int8":
        return adam_int8(lr)
    if name == "sgd":
        return sgd(lr, momentum=0.9)
    raise ValueError(name)


def _select(tree, labels, key):
    """The sub-tree of leaves labelled ``key`` (empty dicts dropped)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            sub = _select(v, labels[k], key)
            if sub is not None:
                out[k] = sub
        return out or None
    return tree if labels == key else None


def _merge(base, sub):
    if sub is None:
        return base
    if isinstance(base, dict):
        return {k: _merge(v, sub.get(k)) for k, v in base.items()}
    return sub


def multi_optimizer(partition_fn, optimizers: dict) -> Optimizer:
    """Route different leaves to different optimizers.

    ``partition_fn(path, leaf) -> key in optimizers``, ``path`` the tuple
    of dict keys.  Used for the search phase: DNN weights -> Adam,
    selection parameters -> SGD(0.9) with their own LR (paper Sec.
    5.1.1).  Each optimizer keeps state for the leaves it owns only; the
    JAX package keeps a full-tree state per optimizer and masks the
    gradients, which updates the owned leaves identically.
    """
    def init(params):
        labels = tree_map_with_path(partition_fn, params)
        state = {}
        for key, opt in optimizers.items():
            sub = _select(params, labels, key)
            state[key] = opt.init(sub) if sub is not None else ()
        return state

    def update(grads, state, params, step, axes=None):
        labels = tree_map_with_path(partition_fn, params)
        new_params = params
        new_states = {}
        for key, opt in optimizers.items():
            sub_p = _select(params, labels, key)
            if sub_p is None:
                new_states[key] = state[key]
                continue
            sub_g = _select(grads, labels, key)
            sub_a = None if axes is None else _select(axes, labels, key)
            p_upd, new_states[key] = opt.update(sub_g, state[key], sub_p,
                                                step, sub_a)
            new_params = _merge(new_params, p_upd)
        return new_params, new_states

    return Optimizer(init, update)
