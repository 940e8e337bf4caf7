"""``jamba-1.5-large-398b-smoke`` decoding at batch 1 under the
``long_500k`` rules on a (2, 2) mesh of four spawned gloo ranks
(``torch_serve_mesh_cases``): ``batch`` unmapped, the attention layer's
64 cache positions over all four ranks (16 a rank, only the last one
writing the decode positions 60-63), the Mamba-2 states' ``ssm_inner``
and the experts over ``model``, the data ranks repeating the
projections.  The hybrid is sub-quadratic, so this cell applies.  Held
against the port's (1, 1) steps, the JAX package's steps on a
four-device CPU mesh, and on every cache shard's shape; no token is
rerouted (a one-token step keeps every token at every expert's
capacity).

Bounds (relative L2 of logits and gathered caches), 1.5x the largest
CPU reading: against (1, 1) 2.8e-2 (reading 1.85e-2, a decode step's
logits), against the JAX mesh steps 4.4e-2 (reading 2.96e-2; the JAX
mesh steps themselves lie 2.95e-2 from the port's (1, 1) steps, their
partitioner contracting the projections over the data-split
``d_model``).
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_serve_mesh_cases as sc
from torch_threads import _one_torch_thread  # noqa: F401

CASE = sc.Case("jamba-1.5-large-398b-smoke", (2, 2), "long", b=1)
SINGLE, JAX = 2.8e-2, 4.4e-2


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


def test_no_token_is_rerouted(world):
    assert [m for m, _ in sc.rerouted(world)] == [0]
