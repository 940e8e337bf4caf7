"""Logical-axis sharding (``repro.distributed.sharding``): one place that
maps model-semantic axes to mesh axes, and the collectives of the layout
the port holds.

Model code names tensor axes logically; the active rule set (installed
by the launcher with :func:`use_mesh`) resolves them to mesh axes.  With
no mesh installed (the CPU tests, one device) everything is a no-op.

The rules are the JAX package's, entry for entry (:data:`DEFAULT_RULES`,
:func:`spec`).  Of the mapped axes the port places two (:data:`HELD`):
``batch`` rows on ``data`` (pure data parallelism) and the ``experts``
axis of an MoE bank on ``model`` (expert parallelism, the reference's
``shard_map`` of ``blocks.moe_layer``).  Every other mapped axis --
``heads``, ``kv_heads``, ``mlp``, ``vocab``, ``ssm_inner``, ``act_seq``
and ``kv_seq`` on ``model``, ``w_embed`` on ``data`` -- stays whole on
each rank: the same math as the reference's tensor-parallel and FSDP
placements, summed in another order.  :func:`constrain` is a no-op for
every axis.

The collectives are ``torch.autograd.Function``s over a process group:

* :func:`copy_to` -- identity forward, all-reduce SUM backward: for what
  every rank of the group holds whole but uses only in part (an MoE
  layer's input, its router weight, a bank's selection probabilities);
* :func:`reduce_from` -- all-reduce SUM forward, identity backward: the
  reference's ``psum`` of the MoE layer's float32 partial outputs and
  its transpose;
* :func:`all_reduce_max` -- no gradient: a sharded bank's per-channel
  absmax.

The group's backend takes the tensors where they lie: NCCL on the card,
gloo on the CPU and on the card (ranks that share one card; the
installed gloo stages CUDA tensors through host memory itself).
Half-width floats are summed in float32 and rounded once.
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
_state = types.SimpleNamespace(rules=None, mesh=None)

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

# the logical axes the port places on their mesh axes; the rest stay whole
HELD = ("batch", "experts")


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


def held_spec(*logical_axes) -> tuple:
    """:func:`spec` with only the :data:`HELD` axes kept: what the port
    places."""
    return tuple(m if a in HELD else None
                 for a, m in zip(logical_axes, spec(*logical_axes)))


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """The reference's ``with_sharding_constraint``: a no-op here (every
    placed axis is placed by the layout itself, see the module note)."""
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


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

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
    return buf.to(t.dtype)


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


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce SUM of the gradient over ``group``
    (None: identity both ways)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce SUM over ``group`` forward, identity backward (None:
    identity both ways)."""
    return x if group is None else _ReduceFrom.apply(x, group)


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
    order within the group, bit for bit (the bytes are gathered)."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    raw = src.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=group)
    return torch.cat([p.view(t.dtype).reshape(src.shape) for p in parts],
                     dim=dim)
