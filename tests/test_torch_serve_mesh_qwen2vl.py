"""The prefill and decode steps of ``qwen2-vl-72b-smoke`` on a (2, 2)
mesh of four spawned gloo ranks (``torch_serve_mesh_cases``), fed the
stub vision frontend's ``embeddings`` (prompt and decode steps): each
rank keeps its rows of the prompt's sequence under the prefill rules
(``sharding.seq_block``), and from there the VLM is a dense decoder
under the placements of ``test_torch_serve_mesh_llama.py``.  Held
against the port's (1, 1) steps, the JAX package's steps jitted on a
four-device CPU mesh, and on every cache shard's shape.

Bounds (relative L2 of logits and gathered caches), 1.5x the largest
CPU reading: against (1, 1) 1.12e-2 (reading 7.4e-3), against the JAX
mesh steps 1.07e-2 (reading 7.1e-3).
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_serve_mesh_cases as sc
from torch_threads import _one_torch_thread  # noqa: F401

CASE = sc.Case("qwen2-vl-72b-smoke", (2, 2), "serve")
SINGLE, JAX = 1.12e-2, 1.07e-2


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
