"""The prefill and decode steps of mamba2-780m-smoke on a (1, 4) mesh of
four spawned gloo ranks (``torch_serve_mesh_cases``): a quarter of the
SSM heads a rank (K5's plain version on the local heads in the prefill,
the one-token recurrence on them in decode), the prompt's rows split
between layers, the returned ``ssm`` and ``conv.x`` states the
``ssm_inner`` shards of ``cache_logical_axes`` (``conv.b`` / ``conv.c``
whole).  Held against the port's (1, 1) steps, the JAX package's steps
on a four-device CPU mesh, and on every state shard's shape.

Bounds (relative L2 of logits and gathered states): against (1, 1)
1.3e-2, 1.5x the CPU reading 8.4e-3 (the row-split ``out_proj``'s
partial sums each rounded to bf16); against the JAX mesh steps 1e-6:
logits and conv windows bitwise, the float32 SSM state 6.6e-7 apart.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_serve_mesh_cases as sc
from torch_threads import _one_torch_thread  # noqa: F401

CASE = sc.Case("mamba2-780m-smoke", (1, 4), "serve", s=64)
SINGLE, JAX = 1.3e-2, 1e-6


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
