"""Prefill and decode step functions (``repro.launch.steps``' serving
steps), as plain functions over the port's LM."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm


def make_prefill_step(cfg: ArchConfig):
    """(params, batch) -> (last-position logits, new dense caches)."""
    def step_fn(params, batch):
        return lm.forward(cfg, params, batch, mode="prefill",
                          logits_mode="last")
    return step_fn


def make_paged_prefill_step(cfg: ArchConfig):
    """Prefill straight into a page pool: ``kv_caches`` is the pool tree
    (written in place), ``tables`` the slot's block tables sliced to the
    live width, ``lens`` the (B,) real prompt lengths.  ``tokens`` may be
    padded to a q-chunk boundary: padded rows are never written to the
    pool, and the logits are read at ``lens[0] - 1``."""
    def step_fn(params, batch, kv_caches, tables, lens):
        return lm.forward(cfg, params, batch, mode="prefill",
                          logits_mode="last", last_pos=lens[0] - 1,
                          caches=kv_caches, pos=lens, tables=tables)
    return step_fn


def make_decode_step(cfg: ArchConfig):
    """``tables`` is the paged block-table tensor (None for dense)."""
    def step_fn(params, token_batch, caches, pos, tables=None):
        return lm.decode_step(cfg, params, token_batch, caches, pos,
                              tables=tables)
    return step_fn
