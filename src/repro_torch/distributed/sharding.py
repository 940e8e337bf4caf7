"""Logical-axis sharding (``repro.distributed.sharding``): one place that
maps model-semantic axes to mesh axes, and the collectives of the
layouts it gives.

Model code names tensor axes logically; the active rule set (installed
by the launcher with :func:`use_mesh`) resolves them to mesh axes.  With
no mesh installed (the CPU tests, one device) everything is a no-op.

The rules are the JAX package's, entry for entry (:data:`DEFAULT_RULES`,
:func:`spec`), and the port places every axis they map: ``batch`` rows
on ``data``, the weights' ``w_embed`` axis on ``data`` (FSDP: a weight
is gathered over ``data`` where it is used), the tensor-parallel axes
``heads_flat``, ``mlp``, ``vocab``, ``ssm_inner`` and ``experts`` on
``model``, and in the training step the residual stream's sequence
(``act_seq``) on ``model``.  A caller who wants fewer placements unmaps
axes through :func:`use_mesh`'s ``rules`` (the reference's override
mechanism).  :func:`constrain` is a no-op that checks ranks: the
placements are made by the layout itself (:class:`Region`, the weight
provider of ``models/lm.py``).

The collectives are ``torch.autograd.Function``s over a process group:

* :func:`copy_to` -- identity forward, all-reduce SUM backward: for what
  every rank of the group holds whole but uses only in part (a region's
  input without a split sequence, a weight no rank of the region splits,
  a split weight's selection probabilities);
* :func:`reduce_from` -- all-reduce SUM forward, identity backward: a
  region's partial outputs summed where the stream is whole;
* :func:`gather` -- all-gather along a dimension, reduce-scatter
  backward: the FSDP gather of a weight, a split sequence entering a
  region;
* :func:`reduce_scatter` -- reduce-scatter along a dimension, all-gather
  backward: a region's partial outputs summed onto the split sequence;
* :func:`sum_shared` -- all-reduce SUM both ways: a sum every rank goes
  on to use for its own part (a split norm's sum of squares);
* :func:`all_reduce_max` -- no gradient: a split weight's per-channel
  absmax.

The group's backend takes the tensors where they lie: NCCL on the card,
gloo on the CPU and on the card (ranks that share one card; an all-gather
or a reduce-scatter of a CUDA tensor over gloo is staged through host
memory here), and the ``fake`` backend of the dry-run
(``torch.testing._internal.distributed.fake_pg``), whose ``meta`` tensors
carry shapes alone.  Half-width floats are summed in float32 and rounded
once; gathers move bytes, bit for bit.  Every collective goes through
one of ``_all_reduce``, ``_all_gather`` and ``_reduce_scatter``, each of
which records its kind and result bytes in the installed
:class:`Ledger` (:func:`count_collectives`).

The serving steps' dense KV cache splits its sequence over ``kv_seq``'s
mesh axes: :func:`kv_offset` is the first position this rank holds,
and :func:`merge_partials` merges the attention partials the ranks
compute over their positions.
"""
from __future__ import annotations

import contextlib
import math
import types
from typing import Optional

import torch
import torch.distributed as dist

# process-wide, not thread-local as the reference's: autograd runs a CUDA
# backward -- and a remat recompute inside it -- on its own device thread
_state = types.SimpleNamespace(rules=None, mesh=None, ledger=None)

DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_seq": "model",          # sequence-parallel residual stream
    "embed": None,               # activations' d_model axis
    "w_embed": "data",           # weights' d_model axis (FSDP)
    "heads": "model",
    "heads_flat": "model",       # fused (H*hd) projection output axis
    "kv_heads": "model",
    "q_hd": None,
    "mlp": "model",
    "experts": "model",
    "vocab": "model",
    "ssm_inner": "model",        # mamba d_inner / heads axis
    "ssm_state": None,
    "layers": None,
    "kv_seq": "data",            # long-context KV cache: shard sequence
    "capacity": None,
}

# the tensor-parallel axes: a mesh that splits one of them (or the
# sequence, the FSDP axis or the cache's sequence) is refused where the
# port places nothing, a page pool (ROADMAP section 1, item 2)
TP_AXES = ("heads", "heads_flat", "mlp", "vocab", "ssm_inner")


def set_rules(rules: Optional[dict], mesh):
    _state.rules = rules
    _state.mesh = mesh


def get_mesh():
    return _state.mesh


def get_rules() -> Optional[dict]:
    return _state.rules


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Install ``(mesh, rules)`` for model code run in this block: the
    defaults updated with ``rules``, each axis the mesh lacks dropped (a
    tuple keeps the axes it has, ``None`` when none)."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    axes = set(mesh.axis_names)

    def filt(v):
        if isinstance(v, tuple):
            kept = tuple(a for a in v if a in axes)
            return kept if kept else None
        return v if v in axes else None

    rules = {k: filt(v) for k, v in rules.items()}
    prev = (get_rules(), get_mesh())
    set_rules(rules, mesh)
    try:
        yield rules
    finally:
        set_rules(*prev)


def spec(*logical_axes) -> tuple:
    """The mesh-axis entry of each logical axis under the current rules
    (a ``PartitionSpec``'s entries: a mesh axis name, a tuple of two or
    more, or ``None``); ``()`` with no rules installed."""
    rules = get_rules()
    if rules is None:
        return ()
    out = []
    for a in logical_axes:
        e = rules.get(a) if a is not None else None
        # PartitionSpec gives a one-axis tuple as the axis
        out.append(e[0] if isinstance(e, tuple) and len(e) == 1 else e)
    return tuple(out)


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """The reference's ``with_sharding_constraint``: a no-op that checks
    ranks (every placed axis is placed by the layout itself, see the
    module note)."""
    mesh = get_mesh()
    if mesh is not None and math.prod(mesh.shape.values()) > 1 \
            and x.ndim != len(logical_axes):
        raise ValueError(f"constrain: {x.ndim}-d tensor, logical axes "
                         f"{logical_axes}")
    return x


def _axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def sharding_for(*logical_axes):
    """The placements of a tensor with these logical axes over the
    installed mesh, one a mesh axis (``torch.distributed.tensor``'s
    ``Shard(dim)`` / ``Replicate()``, as a ``DeviceMesh`` of the mesh's
    shape and axis names takes them); None with no mesh."""
    mesh = get_mesh()
    if mesh is None:
        return None
    from torch.distributed.tensor import Replicate, Shard
    entries = spec(*logical_axes)
    out = []
    for ax in mesh.axis_names:
        dims = [i for i, e in enumerate(entries) if ax in _axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def divisible(dim: int, *logical_axes_entry) -> bool:
    """Check a dim is divisible by the mesh extent of its mapped axes."""
    mesh = get_mesh()
    rules = get_rules()
    if mesh is None or rules is None:
        return True
    total = 1
    for a in logical_axes_entry:
        for ax in _axes(rules.get(a)):
            total *= mesh.shape[ax]
    return dim % total == 0


def mesh_axes(logical: str) -> tuple:
    """The mesh axes ``logical`` maps to under the current rules."""
    rules = get_rules()
    return _axes(rules.get(logical)) if rules is not None else ()


def extent(logical: str) -> int:
    """How many ways the installed mesh splits the logical axis (1 with
    no mesh)."""
    mesh = get_mesh()
    if mesh is None:
        return 1
    return math.prod(mesh.shape[ax] for ax in mesh_axes(logical))


def axis_index(logical: str) -> int:
    """This rank's coordinate along the logical axis' mesh axes."""
    mesh = get_mesh()
    return 0 if mesh is None else mesh.index(mesh_axes(logical))


def axis_group(logical: str):
    """The process group of this rank's peers along the logical axis;
    None when it is not split (no mesh, or extent 1)."""
    if extent(logical) == 1:
        return None
    return get_mesh().group(mesh_axes(logical))


def dim_axes(*logical_axes) -> list:
    """The mesh axes that split each dimension of a tensor with these
    logical axes (a tuple a dimension, empty when whole)."""
    return [_axes(e) for e in spec(*logical_axes)]


def group_of(mesh_axes):
    """The process group of this rank's peers along ``mesh_axes`` (a
    tuple of mesh axis names); None with no mesh or extent 1."""
    mesh = get_mesh()
    if mesh is None or not mesh_axes:
        return None
    return mesh.group(tuple(mesh_axes))


def shard_of(t: torch.Tensor, logical_axes) -> torch.Tensor:
    """This rank's block of a whole tensor with these logical axes under
    the installed mesh: each dimension the rules map cut into equal
    contiguous blocks over its mesh axes, the rank's block kept (a copy;
    ``t`` itself when nothing splits it)."""
    mesh = get_mesh()
    dims = dim_axes(*logical_axes)
    if mesh is None or not dims:
        return t
    if len(dims) != t.dim():
        raise ValueError(f"logical axes {logical_axes} for a tensor of "
                         f"shape {tuple(t.shape)}")
    for dim, axes in enumerate(dims):
        n = mesh.size(axes) if axes else 1
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"axis {dim} of {tuple(t.shape)} does not "
                             f"split {n} ways")
        size = t.shape[dim] // n
        t = t.narrow(dim, mesh.index(axes) * size, size).clone()
    return t


def tp_split(serving: bool = False) -> tuple:
    """The tensor-parallel axes (:data:`TP_AXES`), ``act_seq`` and the
    weights' FSDP axis ``w_embed`` that the installed mesh splits, and
    with ``serving`` the dense cache's ``kv_seq``: the placements the
    port makes on dense caches, and a page pool refuses."""
    names = TP_AXES + ("act_seq", "w_embed") + (("kv_seq",) if serving
                                                else ())
    return tuple(a for a in names if extent(a) > 1)


def refuse_split(what: str, serving: bool = False):
    """ValueError when the installed mesh splits a tensor-parallel,
    sequence, FSDP (or with ``serving`` a cache-sequence) axis
    (:func:`tp_split`) under ``what``, a page pool, which has no logical
    axes (nor in the reference)."""
    split = tp_split(serving)
    if split:
        raise ValueError(
            f"{what} under a mesh that splits {', '.join(split)}: the port "
            f"places these in the training, prefill and decode steps on "
            f"dense caches; a page pool has no logical axes and is not "
            f"placed under a mesh (ROADMAP section 1, item 2; unmap the "
            f"axes through use_mesh's rules)")


def kv_offset(s_local: int) -> int:
    """The first cache position this rank holds when the dense cache's
    sequence (``kv_seq``) is split into blocks of ``s_local`` positions,
    one a rank in row-major order over its mesh axes (0 when whole)."""
    return axis_index("kv_seq") * s_local if extent("kv_seq") > 1 else 0


def merge_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                   group) -> torch.Tensor:
    """Attention over positions split across ``group``, from each rank's
    partials: ``m`` (..., H) the running max of its scores (``-inf``
    where its positions are wholly masked), ``l`` (..., H) the sum of
    ``exp(score - m)`` (0 there) and ``acc`` (..., H, D) the unnormalised
    output, all float32.  One all-gather of the three, then the merge in
    rank order on every rank, so that every rank holds the same bits:
    ``sum_r acc_r e^(m_r - M) / sum_r l_r e^(m_r - M)`` with ``M`` the
    maximum over ranks.  ``group`` None: this rank's partials alone."""
    packed = torch.cat([acc, m[..., None], l[..., None]], dim=-1)
    return merge_stacked(all_gather_cat(packed[None], 0, group))


def merge_stacked(parts: torch.Tensor) -> torch.Tensor:
    """:func:`merge_partials`' merge of the ranks' partials stacked in
    rank order: ``parts`` (n, ..., H, D + 2) holds each rank's ``acc``,
    then ``m``, then ``l`` on the last axis."""
    top = parts[..., -2].amax(dim=0)
    out = den = None
    for r in range(parts.shape[0]):
        scale = torch.exp(parts[r, ..., -2] - top)
        term, dt = parts[r, ..., :-2] * scale[..., None], \
            parts[r, ..., -1] * scale
        out = term if out is None else out + term
        den = dt if den is None else den + dt
    return out / den[..., None]


class Region:
    """A tensor-parallel region: the work of one layer split over the
    mesh axes of its logical axis ``logical`` (``heads_flat`` for
    attention, ``mlp`` for the FFN, ``experts`` for the MoE banks,
    ``ssm_inner`` for Mamba-2), entered from and left to the residual
    stream.

    With the sequence split (``act_seq`` mapped, the training step) the
    region all-gathers the stream's rows on entry and reduce-scatters
    its partial outputs on exit (Megatron's sequence parallelism); with
    the sequence whole it copies the stream in and all-reduces the
    partial outputs.  ``group`` is the group over which the region's
    work is split: a parameter the region uses whole on every rank of
    it (:meth:`shared`) has a partial gradient there and enters through
    :func:`copy_to`.  ``act_seq`` and ``logical`` map to the same mesh
    axes or one of them to none (ValueError otherwise)."""

    def __init__(self, logical: str):
        seq, tp = mesh_axes("act_seq"), mesh_axes(logical)
        if extent("act_seq") == 1:
            seq = ()
        if extent(logical) == 1:
            tp = ()
        if seq and tp and set(seq) != set(tp):
            raise ValueError(f"act_seq on {seq} and {logical} on {tp}: a "
                             f"region splits one set of mesh axes")
        self.axes = seq or tp
        self.seq = group_of(seq)
        self.split = group_of(tp)
        self.group = group_of(self.axes)
        # how many ways, and where, this rank's part of the split axis
        self.n = extent(logical) if tp else 1
        self.i = get_mesh().index(tp) if tp else 0

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The stream (B, S or S / n, D) -> the region's whole-sequence
        input."""
        if self.seq is not None:
            return gather(x, 1, self.seq)
        return copy_to(x, self.split)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """The region's output (partial sums where its work is split) ->
        the stream's layout."""
        if self.seq is None:
            return reduce_from(y, self.split)
        if self.split is not None:
            return reduce_scatter(y, 1, self.seq)
        n = y.shape[1] // dist.get_world_size(self.seq)
        return y.narrow(1, get_mesh().index(self.axes) * n, n)

    def shared(self, t: torch.Tensor) -> torch.Tensor:
        """A parameter every rank of the region uses whole, each for its
        own part."""
        return copy_to(t, self.group)

    def splits(self, axes_of_dims) -> bool:
        """Whether a tensor whose dimensions are split over
        ``axes_of_dims`` (:func:`dim_axes`) is split over the region."""
        return bool(self.axes) and any(set(self.axes) <= set(a)
                                       for a in axes_of_dims)


def seq_block(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole sequence (dim 1) where ``act_seq``
    splits the residual stream -- a stub frontend's embeddings, which
    every rank is handed whole -- else ``x``."""
    n = extent("act_seq")
    if n == 1:
        return x
    if x.shape[1] % n:
        raise ValueError(f"a sequence of {x.shape[1]} rows does not split "
                         f"over {n} ranks")
    m = x.shape[1] // n
    return x.narrow(1, axis_index("act_seq") * m, m)


def seq_gather(x: torch.Tensor) -> torch.Tensor:
    """The residual stream's rows of every rank (the sequence is split
    over ``act_seq``'s mesh axes; else ``x``)."""
    return gather(x, 1, axis_group("act_seq"))


def seq_shared(t: torch.Tensor) -> torch.Tensor:
    """A parameter applied to the split residual stream's rows (a norm's
    weight): its gradient, partial on each rank, summed over the
    sequence's group."""
    return copy_to(t, axis_group("act_seq"))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

class Ledger:
    """Each collective kind's count and result bytes on this rank, in
    the reference's names (``all-reduce``, ``all-gather``,
    ``reduce-scatter``): an all-reduce's buffer (float32 for a
    half-width sum), an all-gather's gathered tensor, a reduce-scatter's
    block (float32 for a half-width sum) -- what ``hlo_analysis`` reads
    off a collective's result type."""

    def __init__(self):
        self.counts: dict = {}
        self.bytes: dict = {}

    def add(self, kind: str, t: torch.Tensor):
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + \
            t.numel() * t.element_size()


@contextlib.contextmanager
def count_collectives():
    """Record every collective of this module in a new :class:`Ledger`
    for the block (yielded); nothing is recorded outside one."""
    prev, _state.ledger = _state.ledger, Ledger()
    try:
        yield _state.ledger
    finally:
        _state.ledger = prev


def _record(kind: str, t: torch.Tensor):
    if _state.ledger is not None:
        _state.ledger.add(kind, t)


def _staged(t: torch.Tensor, group) -> bool:
    """A CUDA tensor over gloo goes through host memory; the other
    backends (NCCL, and the dry-run's ``fake`` one on ``meta`` tensors)
    take it where it lies."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """All-reduce into a new tensor of t's dtype: half-width floats
    summed in float32."""
    buf = t.detach()
    if op == dist.ReduceOp.SUM and buf.dtype in (torch.bfloat16,
                                                 torch.float16):
        buf = buf.float()
    else:
        buf = buf.clone()
    dist.all_reduce(buf, op=op, group=group)
    _record("all-reduce", buf)
    return buf.to(t.dtype)


def _all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``t`` concatenated along ``dim`` in rank
    order within the group, bit for bit (the bytes are gathered)."""
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    raw = src.reshape(-1).view(torch.uint8)
    home = raw.device
    if _staged(raw, group):
        raw = raw.cpu()
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=group)
    out = torch.cat([p.to(home).view(t.dtype).reshape(src.shape)
                     for p in parts], dim=dim)
    _record("all-gather", out)
    return out


def _reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``t`` over the group, this rank's block of ``dim`` (its
    index within the group); half-width floats summed in float32 and
    rounded once."""
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"over {n} ranks")
    buf = t.detach()
    if buf.dtype in (torch.bfloat16, torch.float16):
        buf = buf.float()
    home = buf.device
    if _staged(buf, group):
        buf = buf.cpu()
    chunks = [c.contiguous() for c in buf.chunk(n, dim=dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    _record("reduce-scatter", out)
    return out.to(device=home, dtype=t.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, dist.ReduceOp.SUM, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, dist.ReduceOp.SUM, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce SUM of the gradient over ``group``
    (None: identity both ways)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce SUM over ``group`` forward, identity backward (None:
    identity both ways)."""
    return x if group is None else _ReduceFrom.apply(x, group)


def sum_shared(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce SUM over ``group`` forward and backward (None: identity
    both ways)."""
    return x if group is None else _SumShared.apply(x, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` (bit for
    bit); the backward reduce-scatters the gradient (None: identity)."""
    return x if group is None else _Gather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``x`` over the group, this rank's block along ``dim``;
    the backward all-gathers the gradient (None: identity)."""
    return x if group is None else _Scatter.apply(x, dim, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over ``group``, no gradient."""
    return x.detach() if group is None else _all_reduce(
        x, dist.ReduceOp.MAX, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum over ``group`` (half-width floats in float32,
    rounded once), no gradient."""
    return x.detach() if group is None else _all_reduce(
        x, dist.ReduceOp.SUM, group)


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of ``t`` concatenated along ``dim`` in rank
    order within the group, bit for bit, no gradient (None: ``t``)."""
    return t if group is None else _all_gather(t, dim, group)
