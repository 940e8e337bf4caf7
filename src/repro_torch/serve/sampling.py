"""Per-request sampling configuration and token sampling.

``SamplingParams``, ``batch_need_top_k``, ``make_rng`` and the host
sampler ``sample_token`` are the JAX package's (``repro.serve.sampling``)
as they are: a request samples the same token stream alone or batched.

The device path keeps only the greedy argmax.  The JAX package draws
non-greedy rows on the device from threefry2x32 keys; until that
generator is ported (ROADMAP A6) a non-greedy row on the device path
raises instead of drawing different random numbers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def require_device_sampling(sp: SamplingParams):
    """Raise for a non-greedy request: device sampling draws only argmax
    until the threefry2x32 generator is ported."""
    if not sp.greedy:
        raise NotImplementedError(
            "non-greedy sampling on the device needs the threefry2x32 "
            "generator (ROADMAP A6); use sample_on_device=False for the "
            "host sampler")


def sample_tokens_device(logits: torch.Tensor) -> torch.Tensor:
    """Greedy on-device sampling: (B, V) logits -> (B,) int32 ids."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


def batch_need_top_k(samplings, vocab: int) -> bool:
    """True iff any row of a batch actually truncates
    (``0 < top_k < vocab``)."""
    return any(0 < sp.top_k < vocab for sp in samplings)


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
