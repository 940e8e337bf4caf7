"""Per-request sampling configuration and token sampling.

``SamplingParams``, ``batch_need_top_k``, ``make_rng`` and the host
sampler ``sample_token`` are the JAX package's (``repro.serve.sampling``)
as they are: a request samples the same token stream alone or batched.

The device sampler ``sample_tokens_device`` is the JAX package's too:
per-row temperature, top-k through a full descending sort, and the
Gumbel-max draw, each row keyed by
``fold_in(fold_in(key(seed), uid), token_index)`` with the threefry2x32
generator of ``core/rng.py``, so a row draws the JAX package's Gumbel
noise (to a few ULPs) whatever its batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import rng as trng


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How one request turns logits into tokens.

    temperature == 0 is greedy (argmax); top_k == 0 means no top-k
    truncation; ``seed`` keys the per-request random stream.
    """

    temperature: float = 0.0
    top_k: int = 0
    max_tokens: int = 16
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"SamplingParams.temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"SamplingParams.top_k must be >= 0, "
                             f"got {self.top_k}")
        if self.max_tokens < 1:
            raise ValueError(f"SamplingParams.max_tokens must be >= 1, "
                             f"got {self.max_tokens}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def sample_tokens_device(logits, temperature, top_k, seed, uid,
                         token_index, need_top_k: bool = True):
    """Batched on-device sampling: (B, V) logits -> (B,) int32 ids.

    Per-row (B,) tensors: temperature == 0 rows are greedy (argmax);
    top_k == 0 means no truncation; each row's Gumbel noise comes from
    ``fold_in(fold_in(key(seed), uid), token_index)``, so the draw is a
    function of the request alone.  ``need_top_k`` False skips the
    full-vocab sort (only valid when no row truncates)."""
    logits = logits.float()
    v = logits.shape[-1]
    greedy_tok = torch.argmax(logits, dim=-1)
    temperature = temperature.float()
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    z = logits / safe_t[:, None]
    if need_top_k:
        svals = torch.sort(z, dim=-1, descending=True).values
        kth_idx = torch.clamp(top_k.long() - 1, 0, v - 1)
        kth = torch.gather(svals, 1, kth_idx[:, None])
        keep = (top_k <= 0)[:, None] | (z >= kth)
        z = torch.where(keep, z, torch.full_like(z, -torch.inf))
    seed = seed.long() & 0xFFFFFFFF
    keys = torch.stack([torch.zeros_like(seed), seed], dim=-1)
    keys = trng.fold_in(trng.fold_in(keys, uid.long()), token_index.long())
    g = trng.gumbel(keys, (v,))
    sampled_tok = torch.argmax(z + g, dim=-1)
    return torch.where(temperature > 0, sampled_tok, greedy_tok).to(
        torch.int32)


def batch_need_top_k(samplings, vocab: int, registry=None) -> bool:
    """True iff any row of a batch actually truncates
    (``0 < top_k < vocab``).  With a metrics registry, counts the step
    into ``serve_topk_sort_steps_total{skipped}`` (the top-k-skip hit
    rate)."""
    need = any(0 < sp.top_k < vocab for sp in samplings)
    if registry is not None:
        registry.counter(
            "serve_topk_sort_steps_total",
            "Sampled decode steps by whether the full-vocab top-k sort "
            "was skipped", labels=("skipped",)).inc(
            skipped="false" if need else "true")
    return need


def make_rng(params: SamplingParams, uid: int) -> np.random.Generator:
    """The request's random stream: a function of (seed, uid) only, so
    re-serving the same request replays identical draws."""
    return np.random.default_rng((int(params.seed), int(uid)))


def sample_token(logits: np.ndarray, params: SamplingParams,
                 rng: np.random.Generator) -> int:
    """Draw one token id from a (V,) logits row."""
    logits = np.asarray(logits, np.float64)
    if params.greedy:
        return int(np.argmax(logits))
    z = logits / params.temperature
    if 0 < params.top_k < z.size:
        kth = np.partition(z, -params.top_k)[-params.top_k]
        z = np.where(z >= kth, z, -np.inf)
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(z.size, p=p))
