"""Step functions of ``repro.launch.steps`` over the port's LM: the
training step (with the paper's joint search), prefill and decode; the
per-shape sharding rules and the placements of a logical tree, and the
cut of a whole tree into one rank's shard (and back).

Under a mesh (``distributed.sharding.use_mesh``) the port places every
logical axis the installed rules map: the ``batch`` rows on ``data``,
the weights' ``w_embed`` axis on ``data`` (FSDP), the tensor-parallel
axes and the experts on ``model`` and, in the training step, the
residual stream's sequence on ``model``.  The prefill and decode steps
refuse a mesh that splits a tensor-parallel, sequence or FSDP axis
(ROADMAP section 1, items 2-3), as do the enc-dec, VLM and hybrid
training steps.  ``batch_struct`` and ``cell_artifacts`` (the
reference's dry-run inputs) wait with the dry-run.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import mps
from repro_torch.distributed import sharding
from repro_torch.models import lm
from repro_torch.optim import grad as gradlib
from repro_torch.optim import optimizers
from repro_torch.optim.optimizers import tree_leaves, tree_map


def make_train_step(cfg: ArchConfig, opt: optimizers.Optimizer,
                    search: bool = False, lam: float = 1e-9,
                    clip_norm: float = 1.0):
    """(params, opt_state, batch, step) -> (params, opt_state, loss).

    ``search=True`` runs the paper's joint MPS + pruning objective:
    effective weights from the per-channel selection logits (softmax at
    tau 1) plus ``lam`` times the expected size in bytes.  With
    ``cfg.train_microbatches`` k > 1 the batch is split into k
    micro-batches whose gradients are summed in the parameter dtype, one
    micro-batch's graph live at a time, then divided by k.  The gradients
    are clipped to global norm ``clip_norm`` before ``opt.update``.  The
    step's global gradient norm (before clipping) is left in
    ``step_fn.grad_norm``.

    Under a mesh ``params`` and ``opt_state`` are this rank's shards
    (:func:`shard_tree`) and ``batch`` is the global batch: it is split
    into micro-batches first and each micro-batch's rows then
    contiguously over the ``batch`` axes, as the reference's sharded
    batch is.  The loss is the mean over the global batch and every
    gradient leaf the mean over ``batch``: a leaf split over the data
    axes (FSDP) arrives summed over them by its gather's backward and is
    only divided, every other leaf is all-reduced over them first (the
    sums over the tensor-parallel and expert groups happen in the
    backward, through the collectives of ``sharding``).  The norm counts
    a split leaf's squares over all its ranks and a whole leaf's once;
    ``adam_int8`` takes a split row's scale over the ranks that hold it
    (``opt.update`` is handed the parameters' logical axes).  Every rank then holds the same
    replicated leaves."""
    ctx = mps.SearchCtx(tau=1.0) if search else None
    k = max(cfg.train_microbatches, 1)
    logical = lm.logical_axes(cfg, mps_on=search)

    def loss_of(params, batch):
        return lm.loss_fn(cfg, params, batch, ctx=ctx,
                          lam=lam if search else 0.0, logical=logical)

    def step_fn(params, opt_state, batch, step):
        dp, d = sharding.extent("batch"), sharding.axis_index("batch")
        rows = {key: v.reshape((k, v.shape[0] // k) + v.shape[1:])
                for key, v in batch.items()}
        n = next(iter(rows.values())).shape[1]
        if n % dp:
            raise ValueError(f"a micro-batch of {n} rows does not split over "
                             f"{dp} data ranks")
        rows = {key: v[:, d * (n // dp):(d + 1) * (n // dp)]
                for key, v in rows.items()}
        if k == 1:
            loss, grads = gradlib.value_and_grad(
                loss_of, params, {key: v[0] for key, v in rows.items()})
        else:
            grads, loss = gradlib.accumulate_grads(loss_of, params, rows)
        group = sharding.axis_group("batch")
        if group is not None:
            loss = sharding.all_reduce_sum(loss, group) / dp
            grads = tree_map_axes(_data_mean, logical, grads)
        grads, step_fn.grad_norm = gradlib.clip_by_global_norm(
            grads, clip_norm, norm=_global_norm(grads, logical))
        new_params, new_opt = opt.update(grads, opt_state, params, step,
                                         logical)
        return new_params, new_opt, loss

    step_fn.grad_norm = None
    return step_fn


def _data_mean(axes, g):
    """A gradient leaf's mean over the data axes: summed over those that
    do not split it (a split one arrives summed), then divided by their
    extent."""
    batch = sharding.mesh_axes("batch")
    split = {a for ax in sharding.dim_axes(*axes) for a in ax}
    group = sharding.group_of(tuple(a for a in batch if a not in split))
    return (sharding.all_reduce_sum(g.float(), group)
            / sharding.extent("batch")).to(g.dtype)


def make_prefill_step(cfg: ArchConfig):
    """(params, batch) -> (last-position logits, new dense caches).
    Raises a ValueError under a mesh that splits a tensor-parallel,
    sequence or FSDP axis (ROADMAP section 1, items 2-3)."""
    sharding.refuse_split("the prefill step")

    def step_fn(params, batch):
        return lm.forward(cfg, params, batch, mode="prefill",
                          logits_mode="last")
    return step_fn


def make_paged_prefill_step(cfg: ArchConfig):
    """Prefill straight into a page pool: ``kv_caches`` is the pool tree
    (written in place), ``tables`` the slot's block tables sliced to the
    live width, ``lens`` the (B,) real prompt lengths.  An attention-only
    stack's ``tokens`` (or a stub frontend's ``embeddings``) may be padded
    to a q-chunk boundary: padded rows are never written to the pool, and
    the logits are read at ``lens[0] - 1``.  A hybrid's ``kv_caches``
    holds only its attention layers' pools; its Mamba-2 layers prefill
    from zero and return their new state in the tree.  Refuses a mesh
    as :func:`make_prefill_step` does."""
    sharding.refuse_split("the paged prefill step")

    def step_fn(params, batch, kv_caches, tables, lens):
        return lm.forward(cfg, params, batch, mode="prefill",
                          logits_mode="last", last_pos=lens[0] - 1,
                          caches=kv_caches, pos=lens, tables=tables)
    return step_fn


def make_decode_step(cfg: ArchConfig):
    """``token_batch`` holds ``tokens`` (B, 1) or ``embeddings`` (B, 1,
    D); ``tables`` is the paged block-table tensor (None for dense).
    Refuses a mesh as :func:`make_prefill_step` does."""
    sharding.refuse_split("the decode step")

    def step_fn(params, token_batch, caches, pos, tables=None):
        return lm.decode_step(cfg, params, token_batch, caches, pos,
                              tables=tables)
    return step_fn


def _global_norm(grads, logical):
    """The gradient tree's global norm over all ranks: each leaf's
    squares in tree order, those of a split leaf summed over the mesh
    axes that split it (one all-reduce a set of axes), then one float32
    sum."""
    sq, where = [], {}

    def walk(axes, g):
        split = {a for ax in sharding.dim_axes(*axes) for a in ax}
        group = sharding.group_of(tuple(split))
        if group is not None:
            where.setdefault(tuple(sorted(split)), []).append(len(sq))
        sq.append(torch.sum(torch.square(g.float())))

    tree_map_axes(walk, logical, grads)
    for axes, idx in where.items():
        tot = sharding.all_reduce_sum(torch.stack([sq[i] for i in idx]),
                                      sharding.group_of(axes))
        for j, i in enumerate(idx):
            sq[i] = tot[j]
    return torch.sqrt(torch.sum(torch.stack(sq)))


# ---------------------------------------------------------------------------
# sharding rules and placements
# ---------------------------------------------------------------------------

def tree_map_axes(f, logical, *trees):
    """Map ``f(axes, *leaves)`` over a logical tree (tuple leaves) and
    trees of its structure."""
    if isinstance(logical, dict):
        return {k: tree_map_axes(f, v, *(t[k] for t in trees))
                for k, v in logical.items()}
    return f(logical, *trees)


def shape_rules(shape: ShapeConfig) -> dict:
    """Per-shape sharding rule overrides (``steps.shape_rules``)."""
    if shape.kind == "train":
        return {"act_seq": "model"}
    if shape.kind == "prefill":
        return {"act_seq": "model", "kv_seq": "model"}
    if shape.global_batch == 1:      # long-context: shard the KV sequence
        return {"batch": None, "act_seq": None,
                "kv_seq": ("pod", "data", "model")}
    return {"act_seq": None, "kv_seq": "model"}


def batch_logical(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The logical axes of one step's inputs (``steps.batch_logical``)."""
    out = {}
    if shape.kind == "decode":
        key = "tokens" if cfg.frontend == "none" else "embeddings"
        out[key] = ("batch", None) if key == "tokens" else \
            ("batch", None, None)
        return out
    if cfg.frontend == "none":
        out["tokens"] = ("batch", None)
    else:
        out["embeddings"] = ("batch", None, None)
    if cfg.is_encdec:
        out["enc_embeddings"] = ("batch", None, None)
    if shape.kind == "train":
        out["targets"] = ("batch", None)
    return out


def resolve_shardings(mesh, logical_tree):
    """Logical tree -> the placements of each leaf over ``mesh``
    (``sharding.sharding_for``: one ``Shard`` / ``Replicate`` a mesh
    axis, the reference's ``NamedSharding`` in ``DeviceMesh`` terms).
    ``mesh`` must be the installed one."""
    if sharding.get_mesh() is not mesh:
        raise ValueError("resolve_shardings: install the mesh first "
                         "(sharding.use_mesh)")
    return tree_map_axes(lambda axes: sharding.sharding_for(*axes),
                         logical_tree)


def _placed(axes, leaf):
    """``(dim, mesh axes)`` of each dimension of ``leaf`` the installed
    mesh splits."""
    dims = sharding.dim_axes(*axes)
    if len(dims) != leaf.dim():
        raise ValueError(f"logical axes {axes} for a leaf of shape "
                         f"{tuple(leaf.shape)}")
    mesh = sharding.get_mesh()
    return [(i, ax) for i, ax in enumerate(dims) if mesh.size(ax) > 1]


def shard_tree(tree, logical_tree):
    """This rank's shard of a whole tree under the installed mesh: each
    dimension whose logical axis the rules map cut into equal contiguous
    blocks over its mesh axes, the rank's block kept (a copy); a whole
    leaf as it is."""
    mesh = sharding.get_mesh()

    def cut(axes, leaf):
        for dim, mesh_axes in _placed(axes, leaf):
            n = mesh.size(mesh_axes)
            if leaf.shape[dim] % n:
                raise ValueError(f"axis {dim} of {tuple(leaf.shape)} does "
                                 f"not split {n} ways")
            size = leaf.shape[dim] // n
            leaf = leaf.narrow(dim, mesh.index(mesh_axes) * size,
                               size).clone()
        return leaf

    return tree_map_axes(cut, logical_tree, tree)


def gather_tree(tree, logical_tree):
    """The whole tree from every rank's :func:`shard_tree` shard (on
    every rank; a collective: all ranks call it with the same tree)."""
    mesh = sharding.get_mesh()

    def join(axes, leaf):
        for dim, mesh_axes in reversed(_placed(axes, leaf)):
            leaf = sharding.all_gather_cat(leaf, dim, mesh.group(mesh_axes))
        return leaf

    return tree_map_axes(join, logical_tree, tree)
