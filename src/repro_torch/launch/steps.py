"""Step functions of ``repro.launch.steps`` over the port's LM: the
training step (with the paper's joint search), prefill and decode."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.core import mps
from repro_torch.models import lm
from repro_torch.optim import grad as gradlib
from repro_torch.optim import optimizers


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
    ``step_fn.grad_norm``."""
    ctx = mps.SearchCtx(tau=1.0) if search else None
    k = max(cfg.train_microbatches, 1)

    def loss_of(params, batch):
        return lm.loss_fn(cfg, params, batch, ctx=ctx,
                          lam=lam if search else 0.0)

    def step_fn(params, opt_state, batch, step):
        if k == 1:
            loss, grads = gradlib.value_and_grad(loss_of, params, batch)
        else:
            micro = {key: v.reshape((k, v.shape[0] // k) + v.shape[1:])
                     for key, v in batch.items()}
            grads, loss = gradlib.accumulate_grads(loss_of, params, micro)
        grads, step_fn.grad_norm = gradlib.clip_by_global_norm(grads,
                                                               clip_norm)
        new_params, new_opt = opt.update(grads, opt_state, params, step)
        return new_params, new_opt, loss

    step_fn.grad_norm = None
    return step_fn


def make_prefill_step(cfg: ArchConfig):
    """(params, batch) -> (last-position logits, new dense caches)."""
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
    from zero and return their new state in the tree."""
    def step_fn(params, batch, kv_caches, tables, lens):
        return lm.forward(cfg, params, batch, mode="prefill",
                          logits_mode="last", last_pos=lens[0] - 1,
                          caches=kv_caches, pos=lens, tables=tables)
    return step_fn


def make_decode_step(cfg: ArchConfig):
    """``token_batch`` holds ``tokens`` (B, 1) or ``embeddings`` (B, 1,
    D); ``tables`` is the paged block-table tensor (None for dense)."""
    def step_fn(params, token_batch, caches, pos, tables=None):
        return lm.decode_step(cfg, params, token_batch, caches, pos,
                              tables=tables)
    return step_fn
