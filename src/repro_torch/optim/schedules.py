"""Learning-rate and temperature schedules (all return step -> float32
tensor), ``repro.optim.schedules`` in torch."""
from __future__ import annotations

import math

import torch


def _f32(v):
    return torch.as_tensor(v, dtype=torch.float32)


def constant(v: float):
    return lambda step: _f32(v)


def exponential_decay(base: float, decay: float, steps_per_epoch: int = 1):
    """Paper: LR * 0.99 per epoch (CIFAR-10)."""
    def fn(step):
        epoch = step // steps_per_epoch
        return _f32(base) * torch.pow(_f32(decay), epoch)
    return fn


def step_decay(base: float, boundaries: tuple, factors: tuple,
               steps_per_epoch: int = 1):
    """Paper GSC: halve at epochs 50/100, /2.5 at 150. Boundaries in epochs."""
    def fn(step):
        epoch = step // steps_per_epoch
        v = _f32(base)
        for b, f in zip(boundaries, factors):
            v = torch.where(_f32(epoch >= b), v * f, v)
        return v
    return fn


def cosine(base: float, total_steps: int, warmup_steps: int = 0,
           final_frac: float = 0.0):
    def fn(step):
        step_f = _f32(step)
        warm = step_f / max(warmup_steps, 1)
        prog = torch.clamp((step_f - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(
            math.pi * prog))
        return base * torch.where(step_f < warmup_steps, warm, cos)
    return fn


def wsd(base: float, total_steps: int, warmup_frac: float = 0.01,
        decay_frac: float = 0.1, final_frac: float = 0.0):
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395)."""
    warmup = max(int(total_steps * warmup_frac), 1)
    decay_start = int(total_steps * (1 - decay_frac))

    def fn(step):
        step_f = _f32(step)
        warm = step_f / warmup
        decay_prog = torch.clamp((step_f - decay_start)
                                 / max(total_steps - decay_start, 1), 0, 1)
        dec = 1 - (1 - final_frac) * decay_prog
        v = torch.where(step_f < warmup, warm,
                        torch.where(step_f < decay_start, _f32(1.0), dec))
        return base * v
    return fn
