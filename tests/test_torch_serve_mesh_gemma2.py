"""The prefill and decode steps of gemma2-2b-smoke on a (2, 2) mesh of
four spawned gloo ranks (``torch_serve_mesh_cases``): the sliding
window (32) and both softcaps, ``heads`` / ``kv_heads`` unmapped by the
arch's overrides (``heads_flat`` still splits ``wq``), the cache's 128
positions split over ``model``, the decode positions 64-67 reaching
back across the rank boundary at 64 through the window.  Held against
the port's (1, 1) steps, the JAX package's steps on a four-device CPU
mesh, and on every cache shard's shape.

Bounds (relative L2 of logits and gathered caches), 1.5x the largest
CPU reading: against (1, 1) 2.1e-2 (reading 1.37e-2), against the JAX
mesh steps 2.3e-2 (reading 1.5e-2; the JAX mesh step itself lies
1.45e-2 from the port's (1, 1) step).
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_serve_mesh_cases as sc
from torch_threads import _one_torch_thread  # noqa: F401

CASE = sc.Case("gemma2-2b-smoke", (2, 2), "serve", s=64, s_max=128)
SINGLE, JAX = 2.1e-2, 2.3e-2


@pytest.fixture(scope="module")
def world():
    return sc.world(CASE)


def test_cache_shard_shapes_are_the_references(world):
    sc.check_shapes(world)


def test_every_rank_holds_the_same_results(world):
    sc.check_same(world)


def test_steps_match_the_single_device_steps(world):
    sc.check_gaps(world, "single", SINGLE)


def test_steps_match_the_jax_mesh_steps(world):
    sc.check_gaps(world, "jax", JAX)
