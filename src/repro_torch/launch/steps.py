"""Step functions of ``repro.launch.steps`` over the port's LM: the
training step (with the paper's joint search), prefill and decode; the
per-shape sharding rules and the placements of a logical tree, and the
cut of a whole tree into one rank's shard (and back).

Under a mesh (``distributed.sharding.use_mesh``) the port places every
logical axis the installed rules map: the ``batch`` rows on ``data``,
the weights' ``w_embed`` axis on ``data`` (FSDP), the tensor-parallel
axes and the experts on ``model``, the residual stream's sequence
(``act_seq``) and the dense cache's (``kv_seq``) where the shape's rules
(:func:`shape_rules`) put them.  The three steps take the global batch
and cut this rank's rows themselves; parameters, optimizer state and
caches are this rank's shards (:func:`shard_tree`); a stub frontend's
``embeddings`` / ``enc_embeddings`` are global too, their sequence cut
by the model where ``act_seq`` splits it.  Every family is placed; the
paged prefill step and a decode step on page pools refuse a mesh that
splits a tensor-parallel, sequence, FSDP or cache-sequence axis (a page
pool has no logical axes; ROADMAP section 1, item 2).  :func:`batch_struct`
and :func:`cell_artifacts` are the dry-run's inputs
(``launch/dryrun.py``): meta tensors of a cell's step arguments and
their placements.
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


def _rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of the global batch's rows (dim 0)
    over the ``batch`` axes, as the reference's sharded batch holds
    them (the tensor itself with ``batch`` unmapped)."""
    dp = sharding.extent("batch")
    if dp == 1:
        return t
    if t.shape[0] % dp:
        raise ValueError(f"a batch of {t.shape[0]} rows does not split over "
                         f"{dp} data ranks")
    n = t.shape[0] // dp
    return t.narrow(0, sharding.axis_index("batch") * n, n)


def make_prefill_step(cfg: ArchConfig):
    """(params, batch) -> (last-position logits, new dense caches).  Under
    a mesh ``batch`` is the global batch (this rank's rows are cut here),
    the logits are this rank's vocab shard of ``("batch", None,
    "vocab")`` and the caches its shards of ``lm.cache_logical_axes``
    (its ``kv_seq`` block of positions)."""

    def step_fn(params, batch):
        return lm.forward(cfg, params, {k: _rows(v) for k, v in
                                        batch.items()},
                          mode="prefill", logits_mode="last")
    return step_fn


def make_paged_prefill_step(cfg: ArchConfig):
    """Prefill straight into a page pool: ``kv_caches`` is the pool tree
    (written in place), ``tables`` the slot's block tables sliced to the
    live width, ``lens`` the (B,) real prompt lengths.  An attention-only
    stack's ``tokens`` (or a stub frontend's ``embeddings``) may be padded
    to a q-chunk boundary: padded rows are never written to the pool, and
    the logits are read at ``lens[0] - 1``.  A hybrid's ``kv_caches``
    holds only its attention layers' pools; its Mamba-2 layers prefill
    from zero and return their new state in the tree.  A page pool has
    no logical axes (nor in the reference): a ValueError under a mesh
    that splits a tensor-parallel, sequence, FSDP or cache-sequence axis
    (ROADMAP section 1, item 2)."""
    sharding.refuse_split("the paged prefill step", serving=True)

    def step_fn(params, batch, kv_caches, tables, lens):
        return lm.forward(cfg, params, batch, mode="prefill",
                          logits_mode="last", last_pos=lens[0] - 1,
                          caches=kv_caches, pos=lens, tables=tables)
    return step_fn


def make_decode_step(cfg: ArchConfig):
    """``token_batch`` holds ``tokens`` (B, 1) or ``embeddings`` (B, 1,
    D); ``tables`` is the paged block-table tensor (None for dense).
    Under a mesh the batch (and a (B,) ``pos``) are global, this rank's
    rows cut here; ``caches`` are its shards, updated in place; the
    logits its vocab shard.  Page pools refuse a split mesh, as
    :func:`make_paged_prefill_step` does."""

    def step_fn(params, token_batch, caches, pos, tables=None):
        pos = torch.as_tensor(pos)
        return lm.decode_step(cfg, params, {k: _rows(v) for k, v in
                                            token_batch.items()},
                              caches, _rows(pos) if pos.dim() else pos,
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


def batch_struct(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """``steps.batch_struct``: one step's inputs as ``meta`` tensors (the
    reference's ``ShapeDtypeStruct``s: the same shapes and dtypes,
    nothing allocated)."""
    b, s = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        if cfg.frontend != "none":
            return {"embeddings": sds((b, 1, cfg.d_model), torch.bfloat16)}
        return {"tokens": sds((b, 1), torch.int32)}
    batch = {}
    if cfg.frontend == "none":
        batch["tokens"] = sds((b, s), torch.int32)
    else:  # precomputed patch/frame embeddings (stub frontend)
        batch["embeddings"] = sds((b, s, cfg.d_model), torch.bfloat16)
    if cfg.is_encdec:
        batch["enc_embeddings"] = sds((b, s, cfg.d_model), torch.bfloat16)
    if shape.kind == "train":
        batch["targets"] = sds((b, s), torch.int32)
    return batch


def cell_artifacts(cfg: ArchConfig, shape: ShapeConfig, mesh,
                   search: bool = False):
    """Everything one (arch x shape) cell's step needs under ``mesh``
    (call inside ``sharding.use_mesh``, the reference's
    ``steps.cell_artifacts``): ``(step, args, in_sh, out_sh, donate)``.
    ``args`` are this rank's ``meta`` arguments: its shards of the
    parameters (:func:`lm.init_params` on ``meta``, the counterpart of
    the reference's ``lm.abstract_params``), of the optimizer state and
    of the caches (:func:`lm.init_caches` on ``meta``, its
    ``ShapeDtypeStruct`` tree), and the global batch
    (:func:`batch_struct`), whose rows the step cuts itself; ``in_sh`` /
    ``out_sh`` the placements of each argument and output
    (:func:`resolve_shardings`, the batch's included);
    ``donate`` the reference's donated argument indices (train (0, 1),
    prefill (), decode (2,)).  Nothing is drawn or allocated."""
    params_log = lm.logical_axes(cfg, mps_on=search)
    params = shard_tree(lm.init_params(cfg, device="meta", mps_on=search),
                        params_log)
    params_sh = resolve_shardings(mesh, params_log)
    b_abs = batch_struct(cfg, shape)
    b_sh = resolve_shardings(mesh, batch_logical(cfg, shape))
    scalar = sharding.sharding_for()
    logits_sh = sharding.sharding_for("batch", None, "vocab")
    cache_log = lm.cache_logical_axes(cfg)
    if shape.kind == "train":
        opt = optimizers.make_optimizer(cfg.optimizer, 1e-4)
        opt_log = optimizers.state_logical_axes(cfg.optimizer, params_log)
        opt_state = opt.init(params)
        step = make_train_step(cfg, opt, search=search)
        args = (params, opt_state, b_abs,
                torch.empty((), dtype=torch.int32, device="meta"))
        opt_sh = resolve_shardings(mesh, opt_log)
        return (step, args, (params_sh, opt_sh, b_sh, scalar),
                (params_sh, opt_sh, scalar), (0, 1))
    cache_sh = resolve_shardings(mesh, cache_log)
    if shape.kind == "prefill":
        return (make_prefill_step(cfg), (params, b_abs), (params_sh, b_sh),
                (logits_sh, cache_sh), ())
    caches = shard_tree(lm.init_caches(cfg, shape.global_batch,
                                       shape.seq_len, enc_len=shape.seq_len,
                                       device="meta"), cache_log)
    args = (params, b_abs, caches,
            torch.empty((), dtype=torch.int32, device="meta"))
    return (make_decode_step(cfg), args, (params_sh, b_sh, cache_sh, scalar),
            (logits_sh, cache_sh), (2,))


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
    return tree_map_axes(lambda axes, leaf: sharding.shard_of(leaf, axes),
                         logical_tree, tree)


def gather_tree(tree, logical_tree):
    """The whole tree from every rank's :func:`shard_tree` shard (on
    every rank; a collective: all ranks call it with the same tree)."""
    mesh = sharding.get_mesh()

    def join(axes, leaf):
        for dim, mesh_axes in reversed(_placed(axes, leaf)):
            leaf = sharding.all_gather_cat(leaf, dim, mesh.group(mesh_axes))
        return leaf

    return tree_map_axes(join, logical_tree, tree)
