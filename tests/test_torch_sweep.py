"""The port's Pareto-front sweep (``repro_torch.sweep``,
``repro_torch.launch.sweep``) against the JAX package's ``repro.sweep``
on the CPU, and its kill/resume invariants inside the port.

Held identical across the packages: the front functions on seeded point
sets (the same points, gaps, adaptive lambdas and iso-accuracy rows),
``plan_hash``, ``SweepSpec`` validation and ``spec_hash``, and the store
layout (each package reads and ``verify()``-s the other's store, and the
same ``put`` writes the same bytes).

The sweeps themselves, from the same (bridged) initial parameters:
* cnn track at ``tests/test_sweep.py``'s spec: the same point names and
  lambdas (the adaptive decision included), channel bits, permutations
  and activation bits equal, PACT clips within 5e-4 (a trained clip is a
  sum of rounding-sized terms, ROADMAP section 3), costs equal (they are
  functions of the bits), scores within 0.04 (near chance after a few
  steps, where near-tied logits flip; ``test_torch_search_e2e``);
* lm track at ``tests/test_sweep.py``'s spec (Adam at lr 0.05): the same
  point names and lambdas; the cold point's plan bits equal; eval losses
  within rtol 3e-2 (measured 0.9% and 1.6%); the warm point's bits equal
  in all but 3% of channels (measured 14 of 1024) and its size within
  0.5%.  Adam's first steps move every entry by about lr in the sign of
  its gradient, so the embedding gradient's f32-vs-bf16 summation (ROADMAP
  section 3) moves near-zero entries apart by 2 lr, and the warm point
  starts from the cold point's diverged weights.

Inside the port, bitwise: a sweep killed in flight and resumed, and one
whose finished entry was corrupted, end with the uninterrupted store's
bytes (entry JSONs, plan hashes, front)."""
import json
import os
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro import sweep as jsweep
from repro.api.plan import CompressionPlan as JPlan
from repro.configs import registry as jreg
from repro.models import cnn as jcnn
from repro.models import lm as jlm
from repro.sweep import front as jfront
from repro_torch import sweep as tsweep
from repro_torch.api import phases as tph
from repro_torch.api.plan import CompressionPlan as TPlan
from repro_torch.bridge import cnn_params_from_jax, lm_params_from_jax
from repro_torch.configs import registry as treg
from repro_torch.launch import sweep as tlaunch
from repro_torch.models import cnn as tcnn
from repro_torch.optim.optimizers import tree_map
from repro_torch.sweep import front as tfront
from torch_threads import _one_torch_thread  # noqa: F401


def cnn_spec(mod=tsweep, **kw):
    base = dict(name="t", track="cnn", bench="gsc", lams=(2.0, 12.0),
                adaptive_points=1, warmup_steps=4, search_steps=4,
                finetune_steps=2, batch=8, width=4, eval_batches=2,
                checkpoint_every=2)
    base.update(kw)
    return mod.SweepSpec(**base)


def lm_spec(mod=tsweep, **kw):
    base = dict(name="lt", track="lm", bench="llama3.2-1b-smoke",
                lams=(0.5, 4.0), warmup_steps=1, search_steps=4,
                finetune_steps=0, batch=4, seq=16, eval_batches=2,
                checkpoint_every=1)
    base.update(kw)
    return mod.SweepSpec(**base)


def run_sweep(spec, root, hooks=(), max_points=None, runner_cls=None):
    store = tsweep.PlanStore(os.path.join(root, "store"))
    runner = (runner_cls or tsweep.SweepRunner)(
        spec, store, os.path.join(root, "work"), verbose=False,
        device="cpu")
    return runner, store, runner.run(max_points=max_points, hooks=hooks)


def store_fingerprint(store):
    """Entry JSON bytes, plan hashes and the front (names in cost order):
    what the byte-identity criterion compares."""
    entries = {}
    for name in store.names():
        with open(store._entry_path(name), "rb") as f:
            entries[name] = f.read()
    plans = sorted(e["plan"] for e in store.entries())
    front = [e["name"] for e in store.front()]
    return entries, plans, front


class Boom(tph.Hook):
    """Raise once on the ``nth`` entry into the phase named ``phase``, at
    its step ``step``."""

    def __init__(self, phase, nth=1, step=0):
        self.phase, self.nth, self.step = phase, nth, step
        self.entered, self.armed = 0, True

    def on_phase_start(self, phase, state):
        if phase.name == self.phase:
            self.entered += 1

    def on_step(self, phase, state, step, metrics, train_state):
        if self.armed and phase.name == self.phase and step == self.step \
                and self.entered == self.nth:
            self.armed = False
            raise RuntimeError("boom")


class _SetParams(tph.Hook):
    """Start every Warmup from given parameters (the JAX init)."""

    def __init__(self, params):
        self.params = params

    def on_phase_start(self, phase, state):
        if phase.name == "warmup":
            state.params = self.params


@pytest.fixture(scope="module")
def cnn_ref(tmp_path_factory):
    """The port's uninterrupted cnn sweep."""
    return run_sweep(cnn_spec(), str(tmp_path_factory.mktemp("cnn_ref")))


@pytest.fixture(scope="module")
def lm_ref(tmp_path_factory):
    """The port's uninterrupted lm sweep."""
    return run_sweep(lm_spec(), str(tmp_path_factory.mktemp("lm_ref")))


# ---------------------------------------------------------------------------
# front math, plan hash, spec identity, store layout: across packages
# ---------------------------------------------------------------------------

def _points(seed, n=9):
    """Points with ties: scores on a 1/16 grid, small integer costs."""
    rng = np.random.default_rng(seed)
    return [{"i": i, "score": float(rng.integers(0, 16)) / 16,
             "cost": float(rng.integers(1, 8)),
             "lam": float(rng.choice([0.0, 0.5, 2.0, 8.0, 32.0]))
             * float(rng.uniform(0.5, 2.0))} for i in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_front_functions_match_jax(seed):
    pts = _points(seed)
    tf, jf = tfront.pareto_front(pts), jfront.pareto_front(pts)
    assert [p["i"] for p in tf] == [p["i"] for p in jf]
    assert tfront.largest_gap(tf) == jfront.largest_gap(jf)
    assert tfront.next_lambda(tf) == jfront.next_lambda(jf)
    assert [tfront.dominates(a, b) for a in pts for b in pts] == \
        [jfront.dominates(a, b) for a in pts for b in pts]
    base = {"w8": (0.5, 6.0), "w2": (0.25, 2.0), "hi": (2.0, 1.0)}
    assert tfront.iso_accuracy_report(tf, base) == \
        jfront.iso_accuracy_report(jf, base)


def _assignment(seed, pw=(0, 2, 4, 8)):
    rng = np.random.default_rng(seed)
    g = tcnn.dscnn(width=4)
    geoms = tcnn.cost_geoms(g)
    gamma = {gm.gamma: rng.choice(pw, size=gm.cout) for gm in geoms}
    return g, {"gamma": gamma,
               "delta": {gm.name: int(rng.choice((4, 8))) for gm in geoms},
               "alpha": {gm.name: float(np.float32(rng.uniform(1, 8)))
                         for gm in geoms}}


@pytest.mark.parametrize("seed", range(3))
def test_plan_hash_and_costs_match_jax(seed):
    g, a = _assignment(seed)
    meta = {"lam": 2.0}
    tp = TPlan.from_assignment(a, (0, 2, 4, 8), (4, 8), meta=meta)
    jp = JPlan.from_assignment(a, (0, 2, 4, 8), (4, 8), meta=meta)
    assert tsweep.plan_hash(tp) == jsweep.plan_hash(jp)
    tg, jg = tcnn.cost_geoms(g), jcnn.cost_geoms(jcnn.dscnn(width=4))
    for model in ("size", "bitops", "ne16", "mpic", "tpu"):
        assert tfront.plan_cost(tg, tp, model) == \
            jfront.plan_cost(jg, jp, model)
    for bits in (2, 8):
        assert tfront.uniform_cost(tg, bits) == jfront.uniform_cost(jg, bits)


def _fill(store_mod, plan_mod, root):
    store = store_mod.PlanStore(root)
    for seed in range(3):
        _, a = _assignment(seed)
        plan = plan_mod.from_assignment(a, (0, 2, 4, 8), (8,),
                                        meta={"seed": seed})
        store.put(plan, f"p{seed}", metrics={"score": 0.1 * seed},
                  costs={"size": 100.0 - seed},
                  lineage={"kind": "point", "lam": float(seed),
                           "parent": None})
    return store


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_read_and_verified_across_packages(tmp_path, writer):
    w_store, w_plan, r_store = (jsweep, JPlan, tsweep) if writer == "jax" \
        else (tsweep, TPlan, jsweep)
    _fill(w_store, w_plan, str(tmp_path / "w"))
    reader = r_store.PlanStore(str(tmp_path / "w"))
    assert reader.verify() == []
    assert reader.names() == ["p0", "p1", "p2"]
    assert [e["name"] for e in reader.front()] == ["p2"]
    for name in reader.names():
        assert r_store.plan_hash(reader.load(name)) == \
            reader.entry(name)["plan"]
    # the same puts from the other package write the same bytes
    other = _fill(r_store, TPlan if writer == "jax" else JPlan,
                  str(tmp_path / "r"))
    for sub in ("entries", "plans"):
        a, b = tmp_path / "w" / sub, tmp_path / "r" / sub
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for f in os.listdir(a):
            if f.endswith(".json"):
                assert (a / f).read_bytes() == (b / f).read_bytes(), f
    assert other.verify() == []


def _corrupt(case, store, name, entry, other):
    """Damage ``store`` as the reference's TestPlanStore cases do;
    returns (callable that must raise, expected message)."""
    plans = store.plans_dir
    if case == "missing_npz":
        os.unlink(os.path.join(plans, entry["plan"] + ".npz"))
        return lambda: store.load(name), r"missing its \.npz"
    if case == "truncated_npz":
        path = os.path.join(plans, entry["plan"] + ".npz")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        return lambda: store.load(name), "corrupt or truncated"
    if case == "corrupt_json":
        with open(store._entry_path(name), "w") as f:
            f.write("{\"entry_version\": 1, \"name\": \"")
        return lambda: store.entry(name), "is corrupt"
    if case == "missing_field":
        with open(store._entry_path(name), "w") as f:
            json.dump({"name": name}, f)
        return lambda: store.entry(name), "missing field"
    # hash_mismatch: another plan's arrays under this plan's hash
    for ext in (".npz", ".json"):
        shutil.copy(os.path.join(plans, other["plan"] + ext),
                    os.path.join(plans, entry["plan"] + ext))
    return lambda: store.load(name), "content-hash check"


@pytest.mark.parametrize("case", ["missing_npz", "truncated_npz",
                                  "corrupt_json", "missing_field",
                                  "hash_mismatch"])
def test_store_corruption_cases(tmp_path, case):
    store = _fill(tsweep, TPlan, str(tmp_path))
    entry, other = store.entry("p1"), store.entry("p2")
    fail, msg = _corrupt(case, store, "p1", entry, other)
    with pytest.raises(tsweep.StoreCorruptError, match=msg):
        fail()
    problems = store.verify()
    assert len(problems) == 1
    assert "p1" in problems[0] or entry["plan"] in problems[0]
    # repair quarantines the bad entry; its bytes stay for forensics
    problems = store.verify(repair=True)
    assert "quarantined" in problems[0]
    assert os.path.exists(os.path.join(store.entries_dir,
                                       "p1.quarantined.json"))
    assert store.names() == ["p0", "p2"] and not store.has("p1")
    assert store.verify() == []
    # the JAX package reads the repaired store the same way
    assert jsweep.PlanStore(str(tmp_path)).verify() == []


def test_store_usage_errors_are_not_corruption(tmp_path):
    store = _fill(tsweep, TPlan, str(tmp_path))
    with pytest.raises(tsweep.StoreError, match="invalid entry name"):
        store.put(store.load("p0"), "a/b")
    with pytest.raises(tsweep.StoreError, match="no plan"):
        store.get("feedbeef")
    with pytest.raises(tsweep.StoreError) as ei:
        store.entry("zz")
    assert not isinstance(ei.value, tsweep.StoreCorruptError)
    assert [e["name"] for e in store.query(lam=1.0)] == ["p1"]


@pytest.mark.parametrize("kw,match", [
    (dict(track="rnn"), "track"), (dict(lams=()), "lams"),
    (dict(lams=(-1.0,)), "lams"), (dict(adaptive_points=-1), "adaptive"),
    (dict(search_steps=0), "search_steps"),
    (dict(warmup_steps=0), "warmup_steps"),
    (dict(finetune_steps=-1), "finetune_steps"),
    (dict(warm_search_steps=0), "warm_search_steps"),
    (dict(eval_batches=0), "batch sizes"),
    (dict(checkpoint_every=-1), "checkpoint_every"),
    (dict(track="lm", cost_model="ne16"), "cost_model")])
def test_spec_validation_matches_jax(kw, match):
    for mod in (jsweep, tsweep):
        with pytest.raises(ValueError, match=match):
            mod.SweepSpec(**kw)


@pytest.mark.parametrize("kw", [{}, dict(search_steps=5),
                                dict(lams=(1, 3.5), warm_search_steps=3),
                                dict(track="lm", bench="llama3.2-1b-smoke",
                                     px=[8])])
def test_spec_hash_matches_jax(kw):
    t, j = cnn_spec(tsweep, **kw), cnn_spec(jsweep, **kw)
    assert t.to_json() == j.to_json()
    assert t.spec_hash() == j.spec_hash()
    assert tsweep.SweepSpec.from_json(j.to_json()) == t
    assert t.warm_search() == j.warm_search()


# ---------------------------------------------------------------------------
# the cnn track
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cnn_both(tmp_path_factory):
    """Both packages' cnn sweeps at the reference test's spec, the
    port's warmups started from the JAX init (bridged), each runner
    writing into its package's metrics registry and point tracer."""
    from repro import obs as jobs
    from repro_torch import obs as tobs
    root = tmp_path_factory.mktemp("cnn_both")
    jo, to = jobs.Observability(), tobs.Observability()
    jstore = jsweep.PlanStore(str(root / "j" / "store"))
    jsum = jsweep.SweepRunner(cnn_spec(jsweep), jstore,
                              str(root / "j" / "work"),
                              registry=jo.registry, tracer=jo.tracer,
                              verbose=False).run()
    g = jcnn.dscnn(width=4)
    init = cnn_params_from_jax(jax.tree.map(
        np.asarray, jcnn.init_params(g, jax.random.key(0))))
    tstore = tsweep.PlanStore(str(root / "t" / "store"))
    tsum = tsweep.SweepRunner(
        cnn_spec(), tstore, str(root / "t" / "work"), registry=to.registry,
        tracer=to.tracer, verbose=False, device="cpu").run(
        hooks=[_SetParams(init)])
    return (jstore, jsum, jo), (tstore, tsum, to)


def test_cnn_sweep_matches_jax(cnn_both):
    """Both packages at the reference test's spec, the port's warmups
    started from the JAX init (bridged)."""
    (jstore, jsum, _), (tstore, tsum, _) = cnn_both
    assert tsum == jsum
    assert tstore.names() == jstore.names()
    for name in jstore.names():
        je, te = jstore.entry(name), tstore.entry(name)
        assert te["lineage"].keys() == je["lineage"].keys()
        for k in ("lam", "warm", "index", "spec", "steps", "saved"):
            assert te["lineage"][k] == je["lineage"][k], (name, k)
        assert te["costs"] == je["costs"]
        assert te["metrics"].keys() == je["metrics"].keys()
        for k in ("score", "acc_final", "acc_float"):
            assert abs(te["metrics"][k] - je["metrics"][k]) <= 0.04
        assert te["metrics"]["size_bytes"] == je["metrics"]["size_bytes"]
        jp, tp = jstore.load(name), tstore.load(name)
        assert tp.channel_bits.keys() == jp.channel_bits.keys()
        for grp in jp.channel_bits:
            np.testing.assert_array_equal(tp.channel_bits[grp],
                                          jp.channel_bits[grp])
            np.testing.assert_array_equal(tp.permutations[grp],
                                          jp.permutations[grp])
        assert tp.act_bits == jp.act_bits
        assert max(abs(tp.alphas[k] - jp.alphas[k]) for k in jp.alphas) \
            <= 5e-4


def test_cnn_summary_and_lineage(cnn_ref):
    _, store, summary = cnn_ref
    assert summary["executed"] >= 2 and summary["loaded"] == 0
    assert summary["complete"] and summary["steps_saved"] > 0
    by_name = {e["name"]: e for e in store.query(kind="point", sweep="t")}
    p0, p1 = by_name["t.pt00"], by_name["t.pt01"]
    assert not p0["lineage"]["warm"] and p0["lineage"]["parent"] is None
    assert p1["lineage"]["warm"] and p1["lineage"]["parent"] == p0["plan"]
    assert p1["lineage"]["saved"] == 4 + 2       # warmup + search / 2
    assert store.verify() == []
    assert jsweep.PlanStore(store.root).verify() == []


def test_cnn_store_resume_is_free_and_identical(cnn_ref, tmp_path):
    runner, store, summary = cnn_ref
    before = store_fingerprint(store)
    s2 = tsweep.SweepRunner(runner.spec, store, str(tmp_path / "w"),
                            verbose=False, device="cpu").run()
    assert s2["executed"] == 0 and s2["loaded"] == summary["executed"]
    assert s2["points"] == summary["points"]
    assert store_fingerprint(store) == before
    other = tsweep.SweepRunner(cnn_spec(search_steps=5), store,
                               str(tmp_path / "w2"), verbose=False,
                               device="cpu")
    with pytest.raises(tsweep.StoreError, match="different SweepSpec"):
        other.run()


def test_cnn_kill_resume_byte_identical(cnn_ref, tmp_path):
    """Killed in the second point's finetune, resumed against the same
    store and workdir: the uninterrupted store's bytes."""
    root = str(tmp_path)
    with pytest.raises(RuntimeError, match="boom"):
        run_sweep(cnn_spec(), root, hooks=(Boom("finetune", nth=2),))
    killed = tsweep.PlanStore(os.path.join(root, "store"))
    assert killed.names() == ["t.pt00"]
    _, store, s2 = run_sweep(cnn_spec(), root)
    assert s2["loaded"] == 1 and s2["executed"] >= 1
    assert store_fingerprint(store) == store_fingerprint(cnn_ref[1])


def test_cnn_corrupt_entry_resume_byte_identical(cnn_ref, tmp_path):
    root = str(tmp_path)
    run_sweep(cnn_spec(), root)
    store = tsweep.PlanStore(os.path.join(root, "store"))
    victim = store.names()[0]
    with open(store._entry_path(victim), "w") as f:
        f.write("{\"entry_version\": 1, \"name\": \"")
    with pytest.raises(tsweep.StoreCorruptError):
        store.entry(victim)
    _, store, s2 = run_sweep(cnn_spec(), root)
    assert s2["executed"] >= 1
    assert os.path.exists(os.path.join(store.entries_dir,
                                       f"{victim}.quarantined.json"))
    assert store.verify() == []
    assert store_fingerprint(store) == store_fingerprint(cnn_ref[1])


def test_cnn_max_points_budget(tmp_path):
    root = str(tmp_path)
    spec = cnn_spec(adaptive_points=0)
    _, store, s1 = run_sweep(spec, root, max_points=1)
    assert s1["executed"] == 1 and not s1["complete"]
    assert store.names() == ["t.pt00"]
    _, store, s2 = run_sweep(spec, root)
    assert s2["loaded"] == 1 and s2["executed"] == 1 and s2["complete"]


def test_cnn_baselines_and_iso_report(cnn_ref):
    runner, store, _ = cnn_ref
    for bits in (8, 2):
        runner.baseline(bits)
    e8, e2 = store.entry("t.w8ref"), store.entry("t.w2ref")
    assert e8["lineage"]["kind"] == "baseline" and e8["lineage"]["bits"] == 8
    assert set(int(b) for b in np.concatenate(list(
        store.load("t.w8ref").channel_bits.values()))) == {8}
    assert e8["costs"]["size"] > e2["costs"]["size"]
    rep = runner.iso_report(baseline_bits=(8, 2))
    fr = store.front(store.query(kind="point", sweep="t"))
    want = tfront.iso_accuracy_report(
        fr, {"w8": (e8["metrics"]["score"], e8["costs"]["size"]),
             "w2": (e2["metrics"]["score"], e2["costs"]["size"])},
        score=lambda e: e["metrics"]["score"],
        cost=lambda e: e["costs"]["size"])
    assert rep == want
    assert runner.baseline(8) == e8          # a store hit


def test_cnn_missing_handoff_message(tmp_path):
    runner = tsweep.SweepRunner(cnn_spec(), tsweep.PlanStore(
        str(tmp_path / "s")), str(tmp_path / "w"), verbose=False,
        device="cpu")
    with pytest.raises(tsweep.StoreError, match="warm start"):
        runner._load_handoff(0, {"x": torch.zeros(1)})


def test_runner_obs_sinks_match_jax(cnn_both):
    """``SweepRunner(registry=, tracer=)``: the JAX package's ``sweep_*``
    and ``compress_*`` families with the same labels and the same point
    and step counts, and the same ``point_*`` events (wall clock left
    out; the trained scores in the JAX package's ``point_finished``
    plan hashes can differ, so those are compared by presence)."""
    (_, _, jo), (_, _, to) = cnn_both
    js, ts = jo.registry.snapshot(), to.registry.snapshot()
    assert ts.keys() == js.keys()
    for name in ("sweep_points_completed_total", "sweep_warm_starts_total",
                 "sweep_steps_saved_total", "sweep_search_steps_total",
                 "sweep_front_size", "sweep_trace_events_total"):
        assert ts[name] == js[name], name
    for name in js:
        assert [s["labels"] for s in ts[name]["series"]] == \
            [s["labels"] for s in js[name]["series"]], name
    strip = lambda evs: [(e.uid, e.kind, sorted(e.extra))
                         for e in evs]
    assert strip(to.tracer.events) == strip(jo.tracer.events)
    assert [e.extra.get("lam") for e in to.tracer.events] == \
        [e.extra.get("lam") for e in jo.tracer.events]


# ---------------------------------------------------------------------------
# the lm track
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_lm_store(tmp_path_factory):
    """The JAX package's lm-track sweep at the reference test's spec."""
    root = tmp_path_factory.mktemp("jax_lm")
    jstore = jsweep.PlanStore(str(root / "store"))
    jsum = jsweep.SweepRunner(lm_spec(jsweep), jstore, str(root / "work"),
                              verbose=False).run()
    return jstore, jsum


def test_lm_sweep_matches_jax(tmp_path, jax_lm_store):
    jstore, jsum = jax_lm_store
    name = "llama3.2-1b-smoke"
    init = lm_params_from_jax(jax.tree.map(np.asarray, jlm.init_params(
        jreg.get(name), jax.random.key(0), mps_on=True)),
        cfg=treg.get(name))

    class JaxInit(tsweep.SweepRunner):
        def _lm_init(self, cfg):
            return tree_map(lambda t: t.clone(), init)

    _, tstore, tsum = run_sweep(lm_spec(), str(tmp_path / "t"),
                                runner_cls=JaxInit)
    assert tsum["points"] == jsum["points"] == ["lt.pt00", "lt.pt01"]
    assert tsum["steps_executed"] == jsum["steps_executed"]
    for name in jstore.names():
        je, te = jstore.entry(name), tstore.entry(name)
        assert te["lineage"]["lam"] == je["lineage"]["lam"]
        assert te["metrics"]["eval_loss"] == pytest.approx(
            je["metrics"]["eval_loss"], rel=3e-2)
        jp, tp = jstore.load(name), tstore.load(name)
        assert tp.channel_bits.keys() == jp.channel_bits.keys()
        total = sum(b.size for b in jp.channel_bits.values())
        differ = sum(int(np.sum(tp.channel_bits[k] != jp.channel_bits[k]))
                     for k in jp.channel_bits)
        if not je["lineage"]["warm"]:
            assert differ == 0, name
        assert differ <= 0.03 * total, (name, differ, total)
        assert te["costs"]["size"] == pytest.approx(je["costs"]["size"],
                                                    rel=5e-3)


def test_jax_sweep_store_serves_as_fleet_tiers(jax_lm_store):
    """The JAX package's sweep store serves as the port fleet's
    ``store:<dir>`` (one tier per front entry) and
    ``store:<dir>/<name>`` tiers."""
    from repro_torch.fleet import poisson_trace
    from repro_torch.launch import fleet as tfleet_launch
    from repro_torch.models import lm as tlm
    jstore, _ = jax_lm_store
    cfg = treg.get("llama3.2-1b-smoke")
    params = tlm.init_params(cfg, device="cpu")
    front = [e["name"] for e in jstore.front(
        jstore.query(kind="point") or None)]
    tiers = tfleet_launch.build_tiers(f"store:{jstore.root}", cfg, params,
                                      8.0)
    assert [t.name for t in tiers] == front
    one = tfleet_launch.build_tier(f"store:{jstore.root}/lt.pt00", cfg,
                                   params, 8.0)
    assert one.name == "lt.pt00"
    jp = jstore.load("lt.pt00")
    assert one.plan.equals(TPlan.from_tree(jp.to_tree(), jp.scalars()))
    flt = tfleet_launch.build_fleet(
        cfg, params, [f"store:{jstore.root}/lt.pt00", "float"],
        policy="round_robin", max_len=32, max_batch=2, cache="paged",
        page_size=8, pages=None, base_step_ms=8.0, device="cpu")
    records = flt.run(poisson_trace(4, rate_rps=100.0, vocab=cfg.vocab,
                                    prompt_len=5, max_tokens=3))
    assert {r.replica for r in records.values()} == {"lt.pt00", "float"}
    assert all(r.status == "finished" and len(r.tokens) == 3
               for r in records.values())


def test_lm_summary_and_plans(lm_ref):
    _, store, summary = lm_ref
    assert summary["executed"] == 2 and summary["complete"]
    cfg = treg.get("llama3.2-1b-smoke")
    from repro_torch.models import lm as tlm
    groups = tlm.serve_weight_groups(cfg, tlm.init_params(cfg,
                                                          device="cpu"))
    for e in store.query(kind="point"):
        plan = store.get(e["plan"])
        assert set(plan.channel_bits) == set(groups)
        assert e["costs"]["size"] > 0
        assert plan.meta["sweep"] == "lt" and "lam" in e["lineage"]
    assert store.verify() == []


def test_lm_kill_resume_byte_identical(lm_ref, tmp_path):
    root = str(tmp_path)
    with pytest.raises(RuntimeError, match="boom"):
        # the lm track's loop calls on_step only (nth=0: no phase start)
        run_sweep(lm_spec(), root, hooks=(Boom("lm_search", nth=0,
                                               step=2),))
    # pt00 died at step 2 with a step-1 checkpoint behind it
    _, store, s2 = run_sweep(lm_spec(), root)
    assert s2["executed"] == 2 and s2["loaded"] == 0
    assert store_fingerprint(store) == store_fingerprint(lm_ref[1])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_sweep_main_on_the_cpu(tmp_path, capsys):
    report = str(tmp_path / "report.json")
    args = ["--device", "cpu", "--track", "cnn", "--bench", "gsc",
            "--width", "4", "--lams", "2,12", "--warmup-steps", "2",
            "--search-steps", "2", "--finetune-steps", "1",
            "--checkpoint-every", "1", "--eval-batches", "1",
            "--store", str(tmp_path / "s"), "--workdir", str(tmp_path / "w"),
            "--baselines", "--report", report]
    summary = tlaunch.main(args)
    out = capsys.readouterr().out
    assert "[sweep] front: sweep.pt0" in out
    assert "iso-accuracy vs w8" in out and "iso-accuracy vs w2" in out
    with open(report) as f:
        assert json.load(f)["points"] == summary["points"] \
            == ["sweep.pt00", "sweep.pt01"]
    m, t = str(tmp_path / "m.prom"), str(tmp_path / "t.jsonl")
    again = tlaunch.main(args + ["--metrics", m, "--trace", t])
    assert again["executed"] == 0 and again["loaded"] == 2
    from repro_torch.obs import validate
    assert validate.validate_files(m, t, validate.SCHEMA_PATH) == []
    with open(t) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds == ["point_enqueued", "point_loaded"] * 2
