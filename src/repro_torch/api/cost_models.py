"""Pluggable cost-model registry (hardware backends for the search), the
JAX package's registry over the port's formulas.

A cost model is one target hardware's complexity estimate and has two faces
(paper Sec. 4.3 / 5.6 -- "well-tailored cost models"):

  * ``expected(geom, gammas, deltas, pw, px, ctx)`` -- differentiable
    expected cost of ONE layer under the current soft selection parameters;
    summed over layers it is the search regularizer ``R``.
  * ``discrete(geom, channel_bits, cin_eff, act_bits=8)`` -- exact cost of
    one layer for a concrete per-channel bit assignment; used for
    deployment reporting (paper Table 3) and post-search refinement.

Models are registered by name and the search refers to them by name
(``JointSearch(cost_model="mygpu")``), so a new hardware target plugs in
without touching ``repro_torch.core``:

    from repro_torch.api import cost_models

    class MyGpu:
        name = "mygpu"
        def expected(self, geom, gammas, deltas, pw, px, ctx): ...
        def discrete(self, geom, channel_bits, cin_eff, act_bits=8): ...

    cost_models.register_cost_model(MyGpu())
    # ... JointSearch(cost_model="mygpu") now works everywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, runtime_checkable

from repro_torch.core import costs as _costs


@runtime_checkable
class CostModel(Protocol):
    """Protocol every registered cost model implements."""

    name: str

    def expected(self, geom, gammas, deltas, pw, px, ctx):
        """Differentiable expected cost of one layer (search regularizer)."""
        ...

    def discrete(self, geom, channel_bits, cin_eff, act_bits: int = 8):
        """Exact cost of one layer for a concrete bit assignment."""
        ...


@dataclasses.dataclass(frozen=True)
class FunctionCostModel:
    """Adapter building a :class:`CostModel` from two plain functions."""

    name: str
    expected_fn: Callable
    discrete_fn: Callable

    def expected(self, geom, gammas, deltas, pw, px, ctx):
        return self.expected_fn(geom, gammas, deltas, pw, px, ctx)

    def discrete(self, geom, channel_bits, cin_eff, act_bits: int = 8):
        return self.discrete_fn(geom, channel_bits, cin_eff, act_bits)


_REGISTRY: dict[str, CostModel] = {}


def register_cost_model(model: CostModel, name: str | None = None,
                        overwrite: bool = False) -> CostModel:
    """Register ``model`` under ``name`` (defaults to ``model.name``)."""
    key = name if name is not None else getattr(model, "name", None)
    if not key:
        raise ValueError("cost model needs a non-empty name")
    if not overwrite and key in _REGISTRY and _REGISTRY[key] is not model:
        raise ValueError(f"cost model {key!r} is already registered "
                         f"(pass overwrite=True to replace it)")
    _REGISTRY[key] = model
    return model


def get_cost_model(name_or_model) -> CostModel:
    """Resolve a registry name (or pass a model instance through)."""
    if isinstance(name_or_model, str):
        try:
            return _REGISTRY[name_or_model]
        except KeyError:
            raise KeyError(
                f"unknown cost model {name_or_model!r}; available: "
                f"{', '.join(available_cost_models())}") from None
    return name_or_model


def available_cost_models() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# built-in hardware models (implementations live in repro_torch.core.costs)
# ---------------------------------------------------------------------------

for _name, _expected, _discrete in (
    ("size", _costs.size_cost, _costs.size_bytes_discrete),
    ("bitops", _costs.bitops_cost, _costs.bitops_discrete),
    ("mpic", _costs.mpic_cost, _costs.mpic_cycles_discrete),
    ("ne16", _costs.ne16_cost,
     lambda geom, bits, cin_eff, act_bits=8:
         _costs.ne16_cycles_discrete(geom, bits, cin_eff)),
    ("tpu", _costs.tpu_cost, _costs.tpu_seconds_discrete),
):
    register_cost_model(FunctionCostModel(_name, _expected, _discrete))
