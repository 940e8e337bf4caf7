"""The port's logical-axis sharding (``distributed/sharding.py``,
``launch/mesh.py``, ``models/lm.logical_axes`` / ``cache_logical_axes``,
``optim/optimizers.state_logical_axes``, ``launch/steps``' rules) against
the JAX package's, in one process.

The JAX side resolves on a one-device mesh with axes ``("data",
"model")`` (and ``("pod", "data", "model")``): resolution reads only the
axis names.  Held equal, leaf for leaf and entry for entry:

* ``DEFAULT_RULES``, and ``use_mesh``' merged and filtered rules for
  every registry arch's ``RULE_OVERRIDES`` under each ``shape_rules``
  kind, on both meshes;
* the trees of ``logical_axes(cfg, mps_on)`` (both values) of every
  registry arch and its smoke variant, ``cache_logical_axes`` and
  ``state_logical_axes`` (``adam``, ``adam_int8``, ``sgd``), and the
  ``spec`` of every leaf under those rules;
* ``batch_logical`` of every shape, ``divisible``, ``constrain`` a no-op
  and ``sharding_for``'s placements.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from jax.sharding import PartitionSpec
from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizers as topt
from torch_threads import _one_torch_thread  # noqa: F401

ARCHS = [n + s for n in jreg.ARCHS for s in ("", "-smoke")]
SHAPES = list(jbase.SHAPES)
AXES = {"2d": ("data", "model"), "3d": ("pod", "data", "model")}


def _jmesh(kind):
    axes = AXES[kind]
    return jax.make_mesh((1,) * len(axes), axes,
                         devices=jax.devices()[:1])


def _tmesh(kind):
    axes = AXES[kind]
    return tmesh.Mesh((1,) * len(axes), axes, device="cpu")


def _rules(arch, shape):
    rules = dict(jreg.RULE_OVERRIDES.get(arch.replace("-smoke", ""), {}))
    rules.update(jsteps.shape_rules(jbase.SHAPES[shape]))
    return rules


def _leaves(tree, path=""):
    """``{path: axes tuple}`` of a logical tree (tuple leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}{k}/"))
        return out
    assert isinstance(tree, tuple), (path, tree)
    return {path[:-1]: tree}


def test_default_rules_match_jax():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    # every tensor-parallel axis is a mapped one
    assert all(tsh.DEFAULT_RULES[a] == "model" for a in tsh.TP_AXES)


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_use_mesh_filters_rules_as_jax(kind):
    """Every arch's overrides under every shape kind, merged over the
    defaults and filtered to the mesh's axes; the rules leave with the
    block."""
    for arch in jreg.ARCHS:
        for shape in SHAPES:
            rules = _rules(arch, shape)
            with jsh.use_mesh(_jmesh(kind), rules) as jr, \
                    tsh.use_mesh(_tmesh(kind), rules) as tr:
                assert tr == jr, (arch, shape)
                assert tsh.get_rules() == jsh.get_rules()
    assert tsh.get_rules() is None and tsh.get_mesh() is None
    assert tsh.spec("batch", None) == ()


def test_shape_rules_and_batch_logical_match_jax():
    for shape in SHAPES:
        js, ts = jbase.SHAPES[shape], tbase.SHAPES[shape]
        assert dataclasses.astuple(ts) == dataclasses.astuple(js)
        assert tsteps.shape_rules(ts) == jsteps.shape_rules(js)
        for arch in ARCHS:
            assert tsteps.batch_logical(treg.get(arch), ts) == \
                jsteps.batch_logical(jreg.get(arch), js), (arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_trees_and_specs_match_jax(arch):
    """``logical_axes`` (both ``mps_on``), ``cache_logical_axes`` and the
    optimizer states' trees equal the JAX package's leaf for leaf; the
    port's tree has ``init_params``' leaves and shapes' ranks; every
    leaf's ``spec`` is the JAX ``PartitionSpec``'s entries under every
    shape's rules, on both meshes."""
    jcfg, tcfg = jreg.get(arch), treg.get(arch)
    trees = {}
    for mps_on in (False, True):
        jl, tl = jlm.logical_axes(jcfg, mps_on), tlm.logical_axes(tcfg,
                                                                  mps_on)
        assert _leaves(tl) == _leaves(jl), mps_on
        shapes = {k: tuple(v.shape) for k, v in _leaves_t(
            tlm.init_params(tcfg, device="meta", mps_on=mps_on)).items()}
        assert {k: len(v) for k, v in shapes.items()} == {
            k: len(v) for k, v in _leaves(tl).items()}
        trees[f"params{int(mps_on)}"] = (jl, tl)
        for opt in ("adam", "adam_int8", "sgd"):
            trees[f"{opt}{int(mps_on)}"] = (
                jopt.state_logical_axes(opt, jl),
                topt.state_logical_axes(opt, tl))
    trees["cache"] = (jlm.cache_logical_axes(jcfg),
                      tlm.cache_logical_axes(tcfg))
    for name, (jt, tt) in trees.items():
        if name.startswith("sgd"):
            assert tt == jt == ()
            continue
        assert _leaves(tt) == _leaves(jt), name
    for kind in AXES:
        for shape in SHAPES:
            rules = _rules(arch, shape)
            with jsh.use_mesh(_jmesh(kind), rules), \
                    tsh.use_mesh(_tmesh(kind), rules):
                for name, (jt, tt) in trees.items():
                    if name.startswith("sgd"):
                        continue
                    for path, axes in _leaves(jt).items():
                        js = jsh.spec(*axes)
                        assert isinstance(js, PartitionSpec)
                        assert tsh.spec(*axes) == tuple(js), (
                            name, path, kind, shape)


def _leaves_t(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves_t(v, f"{path}{k}/"))
        return out
    return {path[:-1]: tree}


class _Grid:
    """A mesh's axis extents without ranks: what a placement reads."""

    def __init__(self, kind):
        self.axis_names = AXES[kind]
        self.shape = {a: 2 for a in self.axis_names}

    def size(self, axes):
        return int(np.prod([self.shape[a] for a in axes]))


@pytest.mark.parametrize("kind", sorted(AXES))
def test_placements_follow_the_spec_for_every_mapped_axis(kind):
    """Every leaf of every registry smoke arch's search tree (and its
    ``adam_int8`` state) is cut along exactly the dimensions whose
    logical axes the reference's train rules map, over the JAX package's
    mesh axes for them (``steps._placed``): FSDP, tensor and expert
    parallelism alike; under the overrides that unmap all but ``batch``
    and ``experts``, along the experts alone."""
    train = jbase.ShapeConfig("train", "train", 32, 4)
    for arch in [a for a in ARCHS if a.endswith("-smoke")]:
        rules = dict(jreg.RULE_OVERRIDES.get(arch[:-len("-smoke")], {}))
        rules.update(jsteps.shape_rules(train))
        logical = tlm.logical_axes(treg.get(arch), mps_on=True)
        trees = {"p": logical,
                 "o": topt.state_logical_axes("adam_int8", logical)}
        for tree in trees.values():
            leaves = _leaves_t(tree)
            for layout in ("full", "ep"):
                over = dict(rules)
                if layout == "ep":
                    over.update({a: None for a in tsh.DEFAULT_RULES
                                 if a not in ("batch", "experts")})
                with jsh.use_mesh(_jmesh(kind), over), \
                        tsh.use_mesh(_Grid(kind), over):
                    for key, axes in leaves.items():
                        meta = torch.empty((2,) * len(axes), device="meta")
                        got = tsteps._placed(axes, meta)
                        want = [(i, tuple(e) if isinstance(e, tuple) else (
                            e,)) for i, e in enumerate(jsh.spec(*axes))
                            if e is not None]
                        assert [(i, tuple(a)) for i, a in got] == want, (
                            arch, key, layout)
                        if layout == "ep":
                            assert all(axes[i] in ("experts", "batch")
                                       for i, _ in got), (arch, key)


def test_divisible_matches_jax():
    for kind in AXES:
        with jsh.use_mesh(_jmesh(kind)), tsh.use_mesh(_tmesh(kind)):
            for dim in (1, 3, 16):
                for entry in (("batch",), ("experts",), ("layers",),
                              ("batch", "experts"), ()):
                    assert tsh.divisible(dim, *entry) == \
                        jsh.divisible(dim, *entry)
    assert tsh.divisible(3, "experts")          # no mesh: always


def test_constrain_is_a_no_op_and_placements_follow_the_spec():
    x = torch.arange(6.0).reshape(2, 3)
    assert tsh.constrain(x, "batch", "mlp") is x
    assert tsh.sharding_for("batch") is None
    from torch.distributed.tensor import Replicate, Shard
    with tsh.use_mesh(_tmesh("2d")):
        assert tsh.constrain(x, "batch", "mlp") is x
        assert tsh.sharding_for("layers", "experts", "w_embed", None) == (
            Shard(2), Shard(1))
        assert tsh.sharding_for("batch", None) == (Shard(0), Replicate())
        assert tsh.sharding_for(None, None) == (Replicate(), Replicate())
        mesh = tsh.get_mesh()
        tree = tsteps.resolve_shardings(mesh, {"a": ("batch", None),
                                               "b": {"c": (None,)}})
        assert tree == {"a": (Shard(0), Replicate()),
                        "b": {"c": (Replicate(), Replicate())}}
    with pytest.raises(ValueError, match="install the mesh"):
        tsteps.resolve_shardings(_tmesh("2d"), {"a": (None,)})


def test_mesh_lays_out_ranks_row_major_and_refuses_a_short_world():
    """A one-rank mesh needs no process group; ``make_debug_mesh`` asks
    for the rank count it needs; the production mesh names 256 / 512."""
    m = tmesh.make_debug_mesh(1, 1, device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.rank == 0
    assert m.index("model") == 0 and m.group("model") is None
    np.testing.assert_array_equal(m.devices, [[0]])
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        tmesh.make_debug_mesh(2, 2, device="cpu")
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")


def test_installed_mesh_is_seen_from_other_threads():
    """Autograd runs a CUDA backward -- and a remat recompute inside it,
    which routes an MoE layer again -- on its own device thread: the
    installed mesh and rules are the process's, not the installing
    thread's (a thread-local mesh left the recompute without one)."""
    import threading
    seen = {}
    with tsh.use_mesh(_tmesh("2d")) as rules:
        t = threading.Thread(target=lambda: seen.update(
            mesh=tsh.get_mesh(), rules=tsh.get_rules()))
        t.start()
        t.join()
        assert seen["mesh"] is tsh.get_mesh() and seen["rules"] == rules
    assert tsh.get_mesh() is None
