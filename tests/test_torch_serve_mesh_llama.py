"""The prefill and decode steps of llama3.2-1b-smoke on a (2, 2) mesh of
four spawned gloo ranks (``torch_serve_mesh_cases``): under the prefill
rules (FSDP over ``data``; the sequence, the cache's positions, the
query heads, the FFN and the vocab over ``model``) and the
``decode_32k`` rules (rows over ``data``, the cache over ``model``, the
attention merged from each rank's partials); and at batch 1 under the
``long_500k`` rules (the cache over all four ranks, only the last one
writing).  Held against the port's (1, 1) steps, against the JAX
package's steps jitted on a four-device CPU mesh, and on every cache
shard's shape.

Bounds (relative L2 of logits and gathered caches), 1.5x the largest
CPU reading: against (1, 1), serve 1.5e-2 (reading 9.7e-3), long 1.6e-2
(reading 1.0e-2) -- a row-split projection's partial sums each rounded
to bf16 before their float32 sum (the single device rounds the whole
product once); against the JAX mesh, serve 1.4e-2 (reading 9.2e-3; the
prefill bitwise, the decode steps apart where the JAX package's
partitioner splits the data-axis products otherwise), long 2.6e-2
(reading 1.7e-2; the JAX mesh step itself lies 1.6e-2 from the port's
(1, 1) step)."""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_serve_mesh_cases as sc
from torch_threads import _one_torch_thread  # noqa: F401

CASES = {"serve": (sc.Case("llama3.2-1b-smoke", (2, 2), "serve"),
                   1.5e-2, 1.4e-2),
         "long": (sc.Case("llama3.2-1b-smoke", (2, 2), "long", b=1),
                  1.6e-2, 2.6e-2)}


@pytest.fixture(scope="module", params=list(CASES))
def world(request):
    case, single, jax = CASES[request.param]
    return {**sc.world(case), "bounds": (single, jax)}


def test_cache_shard_shapes_are_the_references(world):
    sc.check_shapes(world)


def test_every_rank_holds_the_same_results(world):
    sc.check_same(world)


def test_steps_match_the_single_device_steps(world):
    sc.check_gaps(world, "single", world["bounds"][0])


def test_steps_match_the_jax_mesh_steps(world):
    sc.check_gaps(world, "jax", world["bounds"][1])
