"""llama4-scout-17b-a16e-smoke decoding at batch 1 under the
``long_500k`` rules on a (2, 2) mesh of four spawned gloo ranks
(``torch_serve_mesh_cases``): ``batch`` unmapped, the cache's 64
positions over all four ranks (16 a rank), the experts over ``model``.
The decode positions 60-63 sit in the last rank's block, and the
chunked layers' chunk [32, 64) crosses the rank boundary at 48 while the
first two ranks' blocks are wholly masked for them.  Held against the
port's (1, 1) steps, the JAX package's steps on a four-device CPU mesh,
and on every cache shard's shape; the partials of a wholly masked block
and their merge are held in process.

Bounds (relative L2 of logits and gathered caches), 1.5x the largest
CPU reading: against (1, 1) 2.7e-2 (reading 1.8e-2), against the JAX
mesh steps 3.3e-2 (reading 2.19e-2; the JAX mesh step itself lies
2.25e-2 from the port's (1, 1) step).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_serve_mesh_cases as sc
from repro_torch.distributed import sharding
from repro_torch.nn import attention
from torch_threads import _one_torch_thread  # noqa: F401

CASE = sc.Case("llama4-scout-17b-a16e-smoke", (2, 2), "long", b=1)
SINGLE, JAX = 2.7e-2, 3.3e-2


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


@pytest.mark.parametrize("pos", [48, 60, 63])
def test_merged_partials_of_a_chunked_cache_in_four_blocks(pos):
    """Four blocks of 16 positions, the chunked window 32: a block wholly
    outside the token's chunk gives max -inf and denominator 0, and the
    rank-order merge equals the one-device attention within 1e-6
    relative L2 (float32 partials; reading at most 2e-7)."""
    g = torch.Generator().manual_seed(pos)
    q = torch.randn(2, 1, 4, 16, generator=g)
    k = torch.randn(2, 64, 2, 16, generator=g)
    v = torch.randn(2, 64, 2, 16, generator=g)
    want = attention.decode_attention(q, k, v, pos, window=32, chunked=True)
    parts = []
    for r in range(4):
        m, l, acc = attention.decode_attention_partial(
            q, k[:, 16 * r:16 * (r + 1)], v[:, 16 * r:16 * (r + 1)], pos,
            offset=16 * r, window=32, chunked=True)
        masked = 16 * (r + 1) <= (pos // 32) * 32 or 16 * r > pos
        assert bool(torch.isinf(m).all()) == masked
        if masked:
            assert torch.count_nonzero(l) == 0 and torch.count_nonzero(
                acc) == 0
        parts.append(torch.cat([acc, m[..., None], l[..., None]], -1))
    got = sharding.merge_stacked(torch.stack(parts))
    assert math.isfinite(float(got.abs().max()))
    assert sc.rel(got.numpy(), want[:, 0].numpy()) <= 1e-6
