"""Deterministic synthetic classification sets (``repro.data.synthetic``),
made on the requested device with the port's threefry generator.

The paper's datasets (CIFAR-10, GSC v2, Tiny ImageNet) are replaced by
synthetic sets with the same tensor shapes and class counts: each class
has a fixed smooth template; a sample is template + noise, rolled by a
random shift along the width.  Every batch is a function of
(spec, step, batch, seed), drawn through the same key stream as the JAX
package, so both packages see the same labels and, to a few float32
ULPs, the same images.

Quirk kept from the reference: the templates are keyed by
``abs(hash(spec.name)) % 2**31``, and Python salts string hashes per
process, so templates (and the two packages' agreement) hold only within
one process.

``lm_batch`` is the LM token stream, drawn through the same key stream
as the JAX package, so its tokens and targets equal the reference's int
for int.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import rng as trng


@dataclasses.dataclass(frozen=True)
class ClassificationSpec:
    name: str
    shape: tuple[int, int, int]
    num_classes: int
    noise: float = 0.35


CIFAR10_LIKE = ClassificationSpec("cifar10-like", (32, 32, 3), 10)
GSC_LIKE = ClassificationSpec("gsc-like", (49, 10, 1), 12)
TINYIMAGENET_LIKE = ClassificationSpec("tinyimagenet-like", (64, 64, 3), 200)

DATASETS = {"cifar10": CIFAR10_LIKE, "gsc": GSC_LIKE,
            "tinyimagenet": TINYIMAGENET_LIKE}

def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) interpolation weights of ``jax.image.resize``'s
    "linear" method: a triangle kernel at half-pixel sample positions,
    normalised over the taps inside the image (so the edge samples take
    the edge pixel), float32 as the reference computes them."""
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = torch.tensor(1.0 / (n_out / n_in), **f32)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, **f32)[:, None])
    wts = torch.clamp_min(1 - x, 0.0)
    total = torch.sum(wts, dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    wts = torch.where(total.abs() > eps,
                      wts / torch.where(total != 0, total,
                                        torch.ones_like(total)),
                      torch.zeros_like(wts))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wts, torch.zeros_like(wts))


def resize_linear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(img, (n, h, w, c), "linear")`` for upsampling
    NHWC images (the only direction the templates use)."""
    wh = _linear_weights(img.shape[1], h, img.device)
    ww = _linear_weights(img.shape[2], w, img.device)
    return torch.einsum("nhwc,hH,wW->nHWc", img, wh, ww)


def _templates(spec: ClassificationSpec, device) -> torch.Tensor:
    """Smooth per-class templates, fixed by the dataset name."""
    key = trng.key(abs(hash(spec.name)) % (2 ** 31), device)
    h, w, c = spec.shape
    # low-frequency template: upsampled coarse noise
    coarse = trng.normal(key, (spec.num_classes, max(h // 4, 1),
                               max(w // 4, 1), c))
    t = resize_linear(coarse, h, w)
    return t / torch.clamp_min(torch.std(t, unbiased=False), 1e-6)


def class_batch(spec: ClassificationSpec, step: int, batch: int,
                seed: int = 0, device=None):
    """Pure function (spec, step, batch, seed) -> (x (B, H, W, C) f32,
    y (B,) int32), made on ``device``."""
    dev = torch.device("cpu" if device is None else device)
    key = trng.fold_in(trng.fold_in(trng.key(seed, dev), step), 1)
    ky, kn, ks = trng.split(key, 3)
    y = trng.randint(ky, (batch,), 0, spec.num_classes)
    temps = _templates(spec, dev)[y.long()]
    noise = torch.tensor(spec.noise, dtype=torch.float32, device=dev) * \
        trng.normal(kn, (batch,) + spec.shape)
    shift = trng.randint(ks, (batch,), -2, 3)
    x = temps + noise
    # per-sample roll along the width: out[b, :, j] = x[b, :, j - shift[b]]
    w = spec.shape[1]
    src = (torch.arange(w, device=dev)[None, :] - shift.long()[:, None]) % w
    idx = src[:, None, :, None].expand(batch, spec.shape[0], w, spec.shape[2])
    return torch.gather(x, 2, idx), y


def eval_set(spec: ClassificationSpec, n_batches: int, batch: int,
             seed: int = 10_000, device=None):
    return [class_batch(spec, 10_000_000 + i, batch, seed, device)
            for i in range(n_batches)]


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------

def lm_batch(vocab: int, seq_len: int, batch: int, step: int,
             seed: int = 0, structure: float = 0.9, device=None):
    """Deterministic learnable token stream (``repro.data.synthetic.
    lm_batch``): tokens follow the noisy affine recurrence ``t[i+1] =
    (a * t[i] + b) % vocab`` with per-sequence ``(a, b)`` drawn from a
    tiny set.  Returns {"tokens", "targets"} of (batch, seq_len - 1)
    int32 on ``device`` (default cpu)."""
    dev = torch.device("cpu" if device is None else device)
    key = trng.fold_in(trng.key(seed, dev), step)
    k0, k1, k2, k3 = trng.split(key, 4)
    mults = torch.tensor([3, 5, 7, 11], dtype=torch.int64, device=dev)
    a = mults[trng.randint(k0, (batch,), 0, 4).long()]
    b = trng.randint(k1, (batch,), 0, 13).long()
    t = trng.randint(k2, (batch,), 0, vocab).long()
    toks = torch.empty((batch, seq_len), dtype=torch.int64, device=dev)
    for i in range(seq_len):
        t = (a * t + b) % vocab
        toks[:, i] = t
    noise_mask = trng.bernoulli(k3, 1 - structure, toks.shape)
    noise = trng.randint(trng.fold_in(k3, 1), toks.shape, 0, vocab)
    toks = torch.where(noise_mask, noise.long(), toks).to(torch.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
