"""The prefill and decode steps of llama3.2-1b-smoke on a (1, 4) mesh of
four spawned gloo ranks (``torch_serve_mesh_cases``): one query head, a
quarter of the FFN columns, of the vocab, of the prompt's rows and of
the cache's positions a rank, no FSDP; the four ranks share the two KV
heads in pairs for the flash pass and each holds every KV head of its
cache block.  Held against the port's (1, 1) steps, the JAX package's
steps on a four-device CPU mesh, and on every cache shard's shape.

Bounds (relative L2 of logits and gathered caches): against (1, 1)
1.4e-2, 1.5x the CPU reading 9.1e-3 (a row-split projection's partial
sums each rounded to bf16); against the JAX mesh steps 1e-6: the
logits are bitwise and the caches 3.4e-7 apart (K's float32 rope, one
ulp on a few entries).
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_serve_mesh_cases as sc
from torch_threads import _one_torch_thread  # noqa: F401

CASE = sc.Case("llama3.2-1b-smoke", (1, 4), "serve")
SINGLE, JAX = 1.4e-2, 1e-6


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
