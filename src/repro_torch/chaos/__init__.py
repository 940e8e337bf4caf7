"""repro_torch.chaos: deterministic fault injection for the serving fleet.

Faults are declared as a seeded schedule of :class:`FaultSpec` records
pinned to the fleet's virtual clock and applied at host boundaries only
(engine session API, cache backend, router, plan store) -- never inside
device code.  The taxonomy, the injection-point contract and the
determinism rules are the JAX package's (``src/repro/chaos/README.md``);
a given ``(spec, targets, seed, horizon)`` gives the same schedule in
both packages.  See
``repro_torch.fleet.health`` for the failure-detection side.
"""
from repro_torch.chaos.faults import FAULT_KINDS, FaultSpec, parse_chaos
from repro_torch.chaos.inject import (ChaosInjector, corrupt_store_entry,
                                poison_params)

__all__ = [
    "FAULT_KINDS", "FaultSpec", "parse_chaos",
    "ChaosInjector", "corrupt_store_entry", "poison_params",
]
