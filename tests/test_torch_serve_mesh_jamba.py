"""The prefill and decode steps of the hybrid,
``jamba-1.5-large-398b-smoke`` (seven Mamba-2 layers, one attention
layer, MoE on the odd slots), on a (2, 2) mesh of four spawned gloo
ranks (``torch_serve_mesh_cases``): 64-token prompts (two SSD chunks)
under the prefill rules, then decode steps under the ``decode_32k``
rules on a 128-position cache.  The mixed cache tree is placed as the
reference places it: the attention layer's ``kv`` split on ``kv_seq``,
each Mamba-2 layer's ``ssm`` and ``conv.x`` on ``ssm_inner``
(``conv.b`` / ``conv.c`` whole).  Held against the port's (1, 1) steps
run shard by shard, the JAX package's steps jitted on a four-device CPU
mesh, and on every cache shard's shape.

Bounds (relative L2), 1.5x the largest CPU reading of each class.
Against the JAX mesh steps 3.3e-2 (reading 2.18e-2, a decode step's
logits).  Against the (1, 1) steps (``SINGLE``): the prefill's logits
5.91e-2, the decode steps' 4.16e-2, the SSM states 4.18e-2, the conv
windows 3.05e-2, the attention cache 1.85e-2.  These pass the 5e-2 the
other families hold: the tensor-parallel sums move an MoE layer's input
by a rounding, and 5 and 10 of the 1408 (expert, token) assignments a
data shard keeps land otherwise at an expert's capacity (the witness
below), as in the training step (``test_torch_tp_jamba.py``).  The JAX
mesh steps route those tokens as the port's mesh does: they lie
5.79e-2 from the (1, 1) steps, and 2.18e-2 from the port's mesh.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_serve_mesh_cases as sc
from torch_threads import _one_torch_thread  # noqa: F401

CASE = sc.Case("jamba-1.5-large-398b-smoke", (2, 2), "serve", s=64,
               s_max=128)
SINGLE = {"prefill": 8.9e-2, "logits": 6.3e-2, "mamba/ssm": 6.3e-2,
          "mamba/conv": 4.6e-2, "": 2.8e-2}
JAX = 3.3e-2


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


def test_gap_is_tokens_rerouted_at_capacity(world):
    """The witness: the mesh run's MoE routings (prefill and every
    decode step; every model rank of a data shard alike) against its
    data shard's (1, 1) run: some (expert, token) assignments differ,
    under 2% of them."""
    moved = sc.rerouted(world)
    assert len(moved) == CASE.mesh[0]
    assert sum(m for m, _ in moved) > 0
    assert all(m < 0.02 * kept for m, kept in moved), moved
