"""The prefill and decode steps of arctic-480b-smoke on a (2, 2) mesh of
four spawned gloo ranks (``torch_serve_mesh_cases``): attention and the
shared FFN tensor-parallel, the expert banks split over ``model`` (two
of four experts a rank), FSDP over ``data``, the sequence and the cache
over ``model``.  Held against the port's (1, 1) steps run on each data
shard's rows alone (an MoE layer's capacity counts a data shard's
tokens), the JAX package's steps on a four-device CPU mesh, and on every
cache shard's shape.

Bounds (relative L2 of logits and gathered caches), 1.5x the largest
CPU reading: against (1, 1) shard by shard 1.7e-2 (reading 1.08e-2),
against the JAX mesh steps 1.8e-2 (reading 1.15e-2).
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_serve_mesh_cases as sc
from torch_threads import _one_torch_thread  # noqa: F401

CASE = sc.Case("arctic-480b-smoke", (2, 2), "serve")
SINGLE, JAX = 1.7e-2, 1.8e-2


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
