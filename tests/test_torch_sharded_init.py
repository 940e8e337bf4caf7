"""``lm.init_params(sharded=True)``: under an installed mesh each leaf
is cut to this rank's shard as soon as it is drawn, so a rank holds at
most one whole leaf beside its shards (path 16 of ``chip_smoke.py``
draws jamba's 16-billion-parameter super-block so on four ranks sharing
one card).  Held bitwise against ``steps.shard_tree`` of the whole
tree drawn from the same seed, for every rank of a (2, 2) and a (1, 4)
mesh, with and without the search's gammas, under the default rules
and the long-context ones (``kv_seq`` over every axis does not touch
the parameters).  The mesh is a grid of coordinates alone: cutting a
leaf needs no process group."""
import itertools

import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro_torch.configs import registry as treg
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.optim.optimizers import tree_leaves
from torch_threads import _one_torch_thread  # noqa: F401


class _Grid:
    """A ``launch.mesh.Mesh``'s axes, extents and one rank's
    coordinates, without its process groups."""

    def __init__(self, shape, coords):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))
        self.coords = dict(zip(self.axis_names, coords))

    _key = meshlib.Mesh._key
    size = meshlib.Mesh.size
    index = meshlib.Mesh.index


RULES = {"train": steps.shape_rules(ShapeConfig("t", "train", 64, 4)),
         "long": steps.shape_rules(ShapeConfig("l", "decode", 64, 1))}


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b-smoke",
                                  "seamless-m4t-medium-smoke"])
def test_sharded_draw_is_the_whole_trees_shard(arch, shape, rules):
    cfg = treg.get(arch)
    for coords in itertools.product(*(range(n) for n in shape)):
        with sharding.use_mesh(_Grid(shape, coords), RULES[rules]):
            for mps_on in (False, True):
                whole = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                       "cpu", mps_on)
                want = steps.shard_tree(whole, lm.logical_axes(cfg, mps_on))
                got = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu", mps_on, sharded=True)
                a, b = tree_leaves(got), tree_leaves(want)
                assert len(a) == len(b)
                assert all(x.shape == y.shape and torch.equal(x, y)
                           for x, y in zip(a, b))
                assert any(x.shape != y.shape for x, y in zip(
                    a, tree_leaves(whole)))
