"""The full placements in the search train step of the hybrid,
``jamba-1.5-large-398b-smoke`` (one super-block: seven Mamba-2 layers
and one attention layer, MoE on the odd slots), on a (2, 2) mesh of
spawned gloo CPU ranks (``torch_mesh_train_cases``, layout ``FULL``):
each kind of layer placed as in its own family's suite
(``test_torch_tp_mamba.py``, ``_llama.py``, ``_arctic.py``) inside one
super-block, every weight's and bank's ``w_embed`` over ``data``.

Held as ``test_torch_tp_llama.py`` holds its step, with bounds per class
of leaves, 1.5x each class's largest CPU reading (relative L2): the
tensor-parallel sums move an MoE layer's input by a rounding, and a few
tokens of a data shard then land on another expert at the capacity
boundary (the witness below: 5-6 of the 640 (expert, token) assignments
a data shard keeps over the step's eight routings), which moves every
leaf's gradient -- as in arctic's step (``test_torch_tp_arctic.py``).  The
single-device bounds of ROADMAP section 3 (6e-2 a leaf) do not hold
this.  Against the port's own step run shard by shard (``STEP_GRAD``):
the router 9.6e-2, the expert banks 0.108 (``l3``'s ``w_down``), the
dense FFNs 4.4e-2, attention 4.5e-2, the Mamba-2 mixers 0.103
(``dt_bias``), the layer norms 8.4e-2, the embedding, head and final
norm 3.6e-2; the loss 2.2e-6.  Against the JAX package's mesh step
(``JAX_GRAD``; the JAX partitioner's sums reroute other tokens): the
router 0.161, the banks 0.136, the dense FFNs 4.7e-2, attention 5.1e-2,
the mixers 9.4e-2, the norms 9.3e-2, the rest 3.8e-2.  The JAX
package's own mesh step lies as far from its ``shards`` function (the
router 0.172, the norms 0.104), and the port's mesh step within the
single-device bounds widened by 1.5x that spread, leaf by leaf.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_mesh_train_cases as mc
import torch_tp_cases as tc
from torch_threads import _one_torch_thread  # noqa: F401

ARCH = "jamba-1.5-large-398b-smoke"
BANKS = ("l1/ffn/", "l3/ffn/", "l5/ffn/", "l7/ffn/")
STEP_LOSS = 3.4e-6
STEP_GRAD = {"router": 0.144, **{b: 0.162 for b in BANKS}, "ffn/": 6.6e-2,
             "l4/mixer": 6.8e-2, "mixer": 0.155, "/norm": 0.126, "": 5.4e-2}
JAX_GRAD = {"router": 0.242, **{b: 0.204 for b in BANKS}, "ffn/": 7.1e-2,
            "l4/mixer": 7.7e-2, "mixer": 0.141, "/norm": 0.139, "": 5.7e-2}


@pytest.fixture(scope="module")
def world():
    return tc.world(ARCH, (2, 2), split_jax=True)


def test_shard_shapes_are_the_references(world):
    tc.check_shapes(world)


def test_step_matches_own_and_jax_steps(world):
    mc.check_step(world, STEP_GRAD, STEP_LOSS, JAX_GRAD)


def test_gap_is_tokens_rerouted_at_capacity(world):
    """The witness: every MoE routing of the mesh step (a data shard's
    tokens, the whole sequence, on every model rank alike) against the
    same micro-batch's routing in the port's step run shard by shard.
    Some (expert, token) assignments differ on each data shard, and
    under 2% of them."""
    routed = world["reference"][2]
    n = len(world["ranks"][0]["routes"])
    assert n == 2 * 4          # two micro-batches, four MoE layers
    for r in world["ranks"]:
        d = r["coords"]["data"]
        mine = r["routes"]
        peer = next(q for q in world["ranks"] if q["coords"]["data"] == d)
        assert all(np.array_equal(a, b) for a, b in zip(mine,
                                                        peer["routes"]))
        moved = sum(mc.rerouted(a, b) for a, b in zip(
            mine, routed[d * n:(d + 1) * n]))
        kept = sum(a.size for a in mine)
        assert 0 < moved < 0.02 * kept, (moved, kept)


def test_replicated_leaves_agree_on_every_rank(world):
    tc.check_replicated(world)


def test_checkpoint_restores_under_other_meshes(world):
    tc.check_restore(world)
