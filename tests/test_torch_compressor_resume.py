"""The port's Compressor checkpoint/resume (``repro_torch.api.compressor``
with ``checkpoint.CheckpointManager``), the reference's resume cases
(``tests/test_api.py``'s ``TestCheckpointResume``) inside the port, the
manager's numpy leaves, and the legacy ``core.pipeline`` shim and
``core.discretize.sublayer_split`` against ``repro.core``.

Resume is held bitwise inside the port: a run killed mid-phase and
resumed gives a plan that ``equals`` the uninterrupted run's and the same
``acc_final``.  Against the JAX package, ``run_pipeline`` from the same
(bridged) folded network gives the same channel bits, permutations and
activation bits, and PACT clips within 5e-4 (a trained clip is a sum of
rounding-sized terms, ROADMAP section 3)."""
import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro.checkpoint import checkpoint as jckpt
from repro.core import discretize as jdisc
from repro.core import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import cnn as jcnn
from repro_torch.api import compressor as tcomp
from repro_torch.api import phases as tph
from repro_torch.bridge import cnn_params_from_jax
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.core import discretize as tdisc
from repro_torch.core import pipeline as tpipe
from repro_torch.data import synthetic as tsyn
from repro_torch.models import cnn as tcnn
from torch_threads import _one_torch_thread  # noqa: F401


class Boom(tph.Hook):
    """Raise once at ``step`` of the phase named ``phase``."""

    def __init__(self, phase, step):
        self.phase, self.step, self.armed = phase, step, True

    def on_step(self, phase, state, step, metrics, train_state):
        if self.armed and phase.name == self.phase and step == self.step:
            self.armed = False
            raise RuntimeError("boom")


def _comp(**kw):
    return tcomp.Compressor(tcnn.dscnn(width=8), tsyn.GSC_LIKE, batch=8,
                            seed=0, device="cpu", **kw)


def _kill_and_resume(comp, mk, tmp_path, phase, step):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    with pytest.raises(RuntimeError, match="boom"):
        comp.run(mk(), hooks=[Boom(phase, step)], checkpoint=mgr,
                 checkpoint_every=4)
    mgr.wait()
    assert mgr.all_steps()            # something was checkpointed
    return comp.run(mk(), checkpoint=CheckpointManager(str(tmp_path),
                                                       keep=3),
                    checkpoint_every=4)


def _recipe():
    return [tph.Warmup(steps=6), tph.JointSearch(steps=10, lam=5.0),
            tph.Finetune(steps=3)]


@pytest.fixture(scope="module")
def reference():
    """The uninterrupted run of :func:`_recipe`."""
    return _comp().run(_recipe())


@pytest.mark.parametrize("phase,step", [("warmup", 5), ("search", 7),
                                        ("finetune", 1)])
def test_interrupted_search_resumes_to_identical_plan(tmp_path, reference,
                                                      phase, step):
    resumed = _kill_and_resume(_comp(), _recipe, tmp_path, phase, step)
    assert resumed.plan.equals(reference.plan)
    assert resumed.acc_final == reference.acc_final
    assert resumed.acc_float == reference.acc_float
    for a, b in ((resumed.net, reference.net),
                 (resumed.mps_params, reference.mps_params)):
        flat_a, flat_b = tckpt._flatten(a), tckpt._flatten(b)
        assert flat_a.keys() == flat_b.keys()
        assert all(np.array_equal(flat_a[k], flat_b[k]) for k in flat_a)


def test_resume_bit_exact_with_activation_mps(tmp_path):
    """px = (4, 8): the delta logits and PACT clips train, and the cost
    normalizer is rebuilt from the initial selection parameters."""
    comp = _comp(px=(4, 8))
    mk = lambda: [tph.Warmup(steps=4),                       # noqa: E731
                  tph.JointSearch(steps=10, lam=5.0, cost_model="bitops"),
                  tph.Finetune(steps=2)]
    reference = comp.run(mk())
    assert set(reference.plan.act_bits.values()) <= {4, 8}
    resumed = _kill_and_resume(comp, mk, tmp_path, "search", 9)
    assert resumed.plan.equals(reference.plan)
    assert resumed.acc_final == reference.acc_final


def test_in_phase_checkpoints_are_incremental(tmp_path):
    """In-phase saves carry the train state and only changed carry leaves
    (none here: the carry moves at phase boundaries); the pinned base
    holds the full carry."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    _comp().run([tph.Warmup(steps=4), tph.JointSearch(steps=8, lam=5.0)],
                checkpoint=mgr, checkpoint_every=4)
    mgr.wait()
    tag = 1_000_004                      # search phase, step 4
    assert tag in mgr.all_steps()
    meta = mgr.peek_meta(tag)
    assert meta["carry_base_tag"] == 1_000_000
    assert meta["carry_delta_keys"] == []
    with np.load(mgr._fname(tag), allow_pickle=False) as z:
        keys = [k for k in z.files if k != "__meta__"]
    assert keys and all(k.startswith("train/") for k in keys)
    base_meta = mgr.peek_meta(1_000_000)
    assert base_meta["boundary"] and base_meta["has_folded"]


def test_corrupt_newest_checkpoint_falls_back_to_older(tmp_path, reference):
    comp = _comp()
    mgr = CheckpointManager(str(tmp_path), keep=3)
    with pytest.raises(RuntimeError, match="boom"):
        comp.run(_recipe(), hooks=[Boom("search", 9)], checkpoint=mgr,
                 checkpoint_every=4)
    mgr.wait()
    newest = mgr.all_steps()[-1]
    assert newest == 1_000_008
    with open(mgr._fname(newest), "wb") as f:
        f.write(b"garbage")
    resumed = comp.run(_recipe(), checkpoint=CheckpointManager(
        str(tmp_path), keep=3), checkpoint_every=4)
    assert resumed.plan.equals(reference.plan)
    assert resumed.acc_final == reference.acc_final


def _quiet_log():
    return tph.MetricsLog(every=1, printer=lambda line: None)


def test_registry_is_idempotent_under_resume(tmp_path):
    """``run(registry=)``: a run killed in the search and resumed into
    the same registry counts every step point once -- the uninterrupted
    run's ``compress_step_points_total`` and ``compress_step_value``
    exactly (the replayed steps are not re-counted), as in the
    reference."""
    from repro_torch.obs import MetricsRegistry
    want = MetricsRegistry()
    _comp().run(_recipe(), hooks=[_quiet_log()], registry=want)
    reg = MetricsRegistry()
    mgr = CheckpointManager(str(tmp_path), keep=3)
    with pytest.raises(RuntimeError, match="boom"):
        _comp().run(_recipe(), hooks=[_quiet_log(), Boom("search", 7)],
                    checkpoint=mgr, checkpoint_every=4, registry=reg)
    mgr.wait()
    _comp().run(_recipe(), hooks=[_quiet_log()], checkpoint=
                CheckpointManager(str(tmp_path), keep=3),
                checkpoint_every=4, registry=reg)
    got, ref = reg.snapshot(), want.snapshot()
    for name in ("compress_step_points_total", "compress_step_value"):
        assert got[name] == ref[name], name
    assert {s["labels"]["phase"] for s in got["compress_phase_seconds"][
        "series"]} == {"warmup", "search", "finetune"}


def test_numpy_leaves_round_trip(tmp_path):
    """A ``CompressionPlan.to_tree()`` (numpy int64 leaves) beside tensors
    saves, restores to the template's types, and flattens to the paths
    the JAX package's ``_flatten`` gives the same tree."""
    plan_tree = {"bits": {"b": np.array([8, 0, 2], np.int64),
                          "a": np.array([4], np.int64)},
                 "perm": {"b": np.array([2, 0, 1], np.int64),
                          "a": np.array([0], np.int64)}}
    tree = {"carry": {"plan": plan_tree, "folded": {
        "conv1": {"w": torch.arange(6.0).reshape(2, 3),
                  "b": torch.zeros(2)}}}, "list": [torch.ones(2)]}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, tree)
    tmpl = {"carry": {"plan": {k: {g: np.zeros_like(v) for g, v in d.items()}
                               for k, d in plan_tree.items()},
                      "folded": {"conv1": {"w": torch.zeros(2, 3),
                                           "b": torch.ones(2)}}},
            "list": [torch.zeros(2)]}
    out, meta = mgr.restore(7, tmpl)
    assert meta["step"] == 7
    got = out["carry"]["plan"]["bits"]["b"]
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    np.testing.assert_array_equal(got, plan_tree["bits"]["b"])
    assert torch.equal(out["carry"]["folded"]["conv1"]["w"],
                       tree["carry"]["folded"]["conv1"]["w"])
    flat = tckpt._flatten(tree)
    jflat = jckpt._flatten({"carry": {"plan": plan_tree, "folded": {
        "conv1": {"w": np.arange(6.0).reshape(2, 3), "b": np.zeros(2)}}},
        "list": [np.ones(2)]})
    assert list(flat) == list(jflat)
    assert all(np.array_equal(flat[k], jflat[k]) for k in flat)


@pytest.mark.parametrize("seed", range(4))
def test_sublayer_split_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pw = (0, 2, 4, 8)
    assignment = {"gamma": {f"g{i}": rng.choice(pw, size=int(n))
                            for i, n in enumerate(rng.integers(1, 40, 5))},
                  "delta": {}, "alpha": {}}
    assert tdisc.sublayer_split(assignment, pw) == \
        jdisc.sublayer_split(assignment, pw)


@pytest.mark.parametrize("kw,match", [
    (dict(pw=()), "non-empty"), (dict(pw=(0,)), "nonzero"),
    (dict(pw=(-2, 8)), ">= 0"), (dict(px=()), "px"),
    (dict(search_steps=0), "search_steps"), (dict(batch=0), "batch"),
    (dict(lam=-1.0), "lam"), (dict(lr_theta=0.0), "learning rates"),
    (dict(tau_end=2.0), "anneal"), (dict(sampler="nope"), "sampler")])
def test_search_config_validation_matches_jax(kw, match):
    for mod in (jpipe, tpipe):
        with pytest.raises(ValueError, match=match):
            mod.SearchConfig(**kw)


def test_run_pipeline_matches_jax():
    """The deprecated shim from the same BN-folded network (warmup
    skipped), search 3 / finetune 2 steps at batch 8, lambda 1e4: the
    JAX package's channel bits, permutations and activation bits, clips
    within 5e-4, and its legacy result keys."""
    g = jcnn.dscnn(width=8)
    folded = jcnn.fold_batchnorm(g, jcnn.init_params(g, jax.random.key(0)))
    kw = dict(warmup_steps=0, search_steps=3, finetune_steps=2, batch=8,
              lam=1e4)
    with pytest.warns(DeprecationWarning):
        want = jpipe.run_pipeline(g, jsyn.GSC_LIKE, jpipe.SearchConfig(**kw),
                                  init_net_folded=folded)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = tpipe.run_pipeline(
            tcnn.dscnn(width=8), tsyn.GSC_LIKE, tpipe.SearchConfig(**kw),
            init_net_folded=cnn_params_from_jax(
                jax.tree.map(np.asarray, folded)), device="cpu")
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert got.keys() == want.keys()
    ga, wa = got["assignment"], want["assignment"]
    assert ga["gamma"].keys() == wa["gamma"].keys()
    for k in wa["gamma"]:
        np.testing.assert_array_equal(ga["gamma"][k], wa["gamma"][k])
    assert ga["delta"] == wa["delta"]
    for k in wa["alpha"]:
        assert abs(ga["alpha"][k] - wa["alpha"][k]) <= 5e-4
    assert got["size_bytes"] == pytest.approx(want["size_bytes"],
                                              rel=1e-12)
    assert 0 < got["prune_fraction"] < 1
    assert got["prune_fraction"] == want["prune_fraction"]
