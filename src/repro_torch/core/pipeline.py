"""Legacy entry point for the three-phase training recipe
(``repro.core.pipeline``, paper Sec. 4.4).

The recipe lives in the composable API: ``api.phases.Warmup`` /
``JointSearch`` / ``Finetune`` driven by ``api.compressor.Compressor``.
This module keeps the original surface -- :class:`SearchConfig` plus
:func:`run_pipeline` -- as a thin, deprecated shim over that API.
"""
from __future__ import annotations

import dataclasses
import warnings

from repro_torch.api.phases import (accuracy, cross_entropy,  # noqa: F401
                                    evaluate, merge_bn_stats as _merge_bn,
                                    phases_from_config)
from repro_torch.core import sampling


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    pw: tuple[int, ...] = (0, 2, 4, 8)
    px: tuple[int, ...] = (8,)
    sampler: str = sampling.SOFTMAX
    cost_model: str = "size"
    lam: float = 1e-4
    warmup_steps: int = 300
    search_steps: int = 300
    finetune_steps: int = 150
    batch: int = 64
    lr_weights: float = 1e-3
    lr_theta: float = 1e-2          # selection params: SGD(0.9) @ 1e-2
    tau0: float = 1.0
    tau_end: float = 0.02           # annealed to by the end of the search
    cost_normalize: bool = True     # R / R(all-8-bit) -> lambda is O(1)
    ne16_refine: bool = False
    layerwise: bool = False         # EdMIPS-style per-layer assignment
    seed: int = 0

    def __post_init__(self):
        def err(msg: str):
            raise ValueError(f"SearchConfig: {msg}")

        if not self.pw:
            err("pw must be non-empty")
        if not any(p != 0 for p in self.pw):
            err(f"pw must contain at least one nonzero precision, "
                f"got {tuple(self.pw)} (an all-pruned search space cannot "
                f"represent a network)")
        if any(p < 0 for p in self.pw):
            err(f"pw precisions must be >= 0, got {tuple(self.pw)}")
        if not self.px or any(p <= 0 for p in self.px):
            err(f"px must be non-empty with positive precisions, "
                f"got {tuple(self.px)}")
        if self.warmup_steps < 0:
            err(f"warmup_steps must be >= 0, got {self.warmup_steps}")
        if self.search_steps < 1:
            err(f"search_steps must be >= 1, got {self.search_steps}")
        if self.finetune_steps < 0:
            err(f"finetune_steps must be >= 0, got {self.finetune_steps}")
        if self.batch < 1:
            err(f"batch must be >= 1, got {self.batch}")
        if self.lam < 0:
            err(f"lam must be >= 0, got {self.lam}")
        if self.lr_weights <= 0 or self.lr_theta <= 0:
            err(f"learning rates must be positive, got "
                f"lr_weights={self.lr_weights}, lr_theta={self.lr_theta}")
        if self.tau0 <= 0:
            err(f"tau0 must be positive, got {self.tau0}")
        if not (0 < self.tau_end < self.tau0):
            err(f"temperature must anneal: need 0 < tau_end < tau0, got "
                f"tau_end={self.tau_end}, tau0={self.tau0}")
        if self.sampler not in sampling.SAMPLERS:
            err(f"sampler must be one of {sampling.SAMPLERS}, "
                f"got {self.sampler!r}")


def run_pipeline(g, spec, cfg: SearchConfig, verbose: bool = False,
                 init_net_folded=None, gamma_init=None, device=None):
    """Deprecated: full warmup -> search -> finetune run (result dict).

    Use ``api.compressor.Compressor`` with explicit phase objects::

        comp = Compressor(g, spec, pw=cfg.pw, px=cfg.px, batch=cfg.batch,
                          seed=cfg.seed)
        res = comp.run(phases_from_config(cfg))

    init_net_folded: start the search from these already-BN-folded params
    (skips warmup).  gamma_init: override the Eq. 13 gamma initialization
    per group.  ``device`` as the Compressor's (``cuda`` unless named).
    """
    warnings.warn(
        "run_pipeline is deprecated; use repro_torch.api.compressor."
        "Compressor with phase objects (see api.phases.phases_from_config)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.api.compressor import Compressor

    comp = Compressor(g, spec, pw=cfg.pw, px=cfg.px, batch=cfg.batch,
                      seed=cfg.seed, device=device)
    phases = phases_from_config(cfg, gamma_init=gamma_init,
                                include_warmup=init_net_folded is None)
    hooks = []
    if verbose:
        from repro_torch.api.phases import MetricsLog
        hooks.append(MetricsLog(every=100))
    res = comp.run(phases, hooks=hooks, init_folded=init_net_folded)
    return res.as_legacy_dict()
