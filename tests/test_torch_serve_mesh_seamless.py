"""The prefill and decode steps of ``seamless-m4t-medium-smoke`` on a
(2, 2) mesh of four spawned gloo ranks (``torch_serve_mesh_cases``), fed
the stub frontends' ``embeddings`` and ``enc_embeddings``: under the
prefill rules the encoder and the decoder run on each rank's rows of
their sequences, the cross attention brings the encoder's whole
sequence in for its K/V (raw float32 weights, placed) and returns
``cross_kv`` whole but for its batch rows (every KV head, every encoder
position: ``cache_logical_axes``); under the ``decode_32k`` rules the
self attention's cache is split over ``model`` and each rank's cross
attention reads its own KV heads of ``cross_kv``.  Held against the
port's (1, 1) steps, the JAX package's steps jitted on a four-device
CPU mesh, and on every cache shard's shape.

Bounds (relative L2 of logits and gathered caches), 1.5x the largest
CPU reading: against (1, 1) 8.7e-3 (reading 5.8e-3), against the JAX
mesh steps 9.1e-3 (reading 6.1e-3).
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_serve_mesh_cases as sc
from torch_threads import _one_torch_thread  # noqa: F401

CASE = sc.Case("seamless-m4t-medium-smoke", (2, 2), "serve")
SINGLE, JAX = 8.7e-3, 9.1e-3


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


def test_cross_cache_holds_every_head_and_position(world):
    """Each rank's ``cross_kv`` shard: its batch rows, all ``S`` encoder
    positions, every KV head."""
    cfg = sc.treg.get(CASE.arch)
    for r in world["ranks"]:
        for tag in ("prefill", "decode"):
            for kv in ("k", "v"):
                shape = tuple(int(x) for x in r[f"shape/{tag}/l0/cross_kv/"
                                                f"{kv}"])
                assert shape[1:] == (CASE.b // CASE.mesh[0], CASE.s,
                                     cfg.hkv_eff, cfg.head_dim), shape
