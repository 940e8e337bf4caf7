"""The port's fault injection (``repro_torch.chaos``) and the fleet's
health monitor against the JAX package's on the CPU, and the port's
parameter poison.

* ``parse_chaos``: equal schedules (every field) and equal errors over a
  grid of specs and seeds; the injector delivers in the same order.
* ``HealthMonitor``: the same observations give the same state
  sequences, ETA multipliers and routability.
* ``poison_params``: on a plan-bound and on a float port server, the
  next step trips the NaN guard (``fault_nan_detected_total``);
  ``undo()`` puts back the very tree object, bitwise as before; a second
  server built from the same parameter tree is untouched, so nothing is
  written in place.
* ``corrupt_store_entry`` makes the port's ``PlanStore`` raise
  ``StoreCorruptError``, with the bytes the JAX package's writes.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro import chaos as jchaos
from repro import fleet as jfleet
from repro import obs as jobs
from repro import sweep as jsweep
from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro_torch import chaos as tchaos
from repro_torch import fleet as tfleet
from repro_torch import obs as tobs
from repro_torch import sweep as tsweep
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import registry as treg
from repro_torch.nn.quantized import PackedLinear
from repro_torch.serve import engine as teng
from repro_torch.serve.sampling import SamplingParams as TSP
from repro_torch.serve.scheduler import Request as TReq
from torch_threads import _one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

SPECS = ["crash", "crash+slow", "crash+slow+nan_plan+pool_pressure",
         "crash@40:w8+slow@30-200:x6", "slow@10-50:x6:float",
         "pool_pressure:p4,nan_plan", "crash@40-200:demo+slow",
         "nan_plan@5+crash@5+slow@5", "store_corrupt:w8+crash"]
TARGETS = ["float", "w8", "demo"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_parse_chaos_schedules_match(spec, seed):
    for horizon in (2000.0, 737.5):
        want = jchaos.parse_chaos(spec, targets=TARGETS, seed=seed,
                                  horizon_ms=horizon)
        got = tchaos.parse_chaos(spec, targets=TARGETS, seed=seed,
                                 horizon_ms=horizon)
        assert [dataclasses.asdict(f) for f in got] == \
            [dataclasses.asdict(f) for f in want]
        assert [f.describe() for f in got] == [f.describe() for f in want]


@pytest.mark.parametrize("spec,targets", [
    ("melt", ["x"]), ("crash:nope", ["x"]), ("", ["x"]), ("crash", []),
    ("slow@50-10", ["x"]), ("slow:x0.5", ["x"]), ("pool_pressure:p0",
                                                  ["x"])])
def test_parse_chaos_errors_match(spec, targets):
    with pytest.raises(ValueError) as want:
        jchaos.parse_chaos(spec, targets=targets, seed=0)
    with pytest.raises(ValueError) as got:
        tchaos.parse_chaos(spec, targets=targets, seed=0)
    assert str(got.value) == str(want.value)


def test_injector_delivery_matches():
    sched = jchaos.parse_chaos("crash+slow+nan_plan+pool_pressure",
                               targets=TARGETS, seed=7)
    tsched = [tchaos.FaultSpec(**dataclasses.asdict(f)) for f in sched]
    ji, ti = jchaos.ChaosInjector(sched), tchaos.ChaosInjector(tsched)
    for now in (0.0, 300.0, 300.0, 650.0, 900.0, 1e9):
        assert ti.next_time() == ji.next_time()
        assert [(p, dataclasses.asdict(s)) for p, s in ti.due(now)] == \
            [(p, dataclasses.asdict(s)) for p, s in ji.due(now)]
    assert ti.exhausted and ji.exhausted
    assert tchaos.FAULT_KINDS == jchaos.FAULT_KINDS


# ---------------------------------------------------------------------------
# the health monitor
# ---------------------------------------------------------------------------

class _FakeServer:
    def __init__(self):
        self.load = {"queued": 0, "active": 1, "queued_tokens": 0,
                     "active_tokens": 4, "pages_in_use": 1,
                     "pages_free": 3, "steps": 0}

    def load_report(self):
        return dict(self.load)


def _health_script(mod, obs_mod, seed):
    """Drive a monitor through seeded observations (progress, stalls,
    idle gaps, pool starvation, crashes, probes); returns what it
    said."""
    rng = np.random.default_rng(seed)
    reg = obs_mod.MetricsRegistry()
    hm = mod.HealthMonitor(registry=reg, watchdog_factor=3.0)
    rep = mod.Replica(tier=mod.TierSpec(name="r", plan=None, step_ms=8.0,
                                        quality=16.0), server=_FakeServer())
    hm.start(["r"])
    t, out = 0.0, []
    for _ in range(80):
        what = rng.integers(0, 7)
        if what <= 2:
            rep.server.load["steps"] += 1
            t += 8.0
        elif what == 3:
            rep.server.load["steps"] += 1
            t += float(rng.uniform(20.0, 80.0))
        elif what == 4:
            rep.server.load.update(pages_free=int(rng.integers(0, 3)),
                                   queued=int(rng.integers(0, 3)),
                                   active=int(rng.integers(0, 2)))
            t += 4.0
        elif what == 5:
            rep.down = not rep.down
            t += 10.0
        elif hm.state("r") == "warming":
            hm.probe_done("r", bool(rng.integers(0, 2)), t)
        hm.observe(rep, t)
        out.append((hm.state("r"), hm.routable("r"),
                    hm.eta_multiplier("r")))
    return out, hm.states(), reg.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_health_monitor_matches(seed):
    got = _health_script(tfleet, tobs, seed)
    assert got == _health_script(jfleet, jobs, seed)
    assert tfleet.HEALTH_STATES == jfleet.HEALTH_STATES
    assert tfleet.ROUTABLE_STATES == jfleet.ROUTABLE_STATES


# ---------------------------------------------------------------------------
# the poison
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama():
    cfg = jreg.get("llama3.2-1b-smoke")
    jp = jlm.init_params(cfg, jax.random.key(0))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp),
                            cfg=treg.get("llama3.2-1b-smoke"))
    return treg.get("llama3.2-1b-smoke"), tp, (cfg, jp)


def _flat(tree, prefix=""):
    """``{path: tensor}`` of a bound tree (a PackedLinear's buffers)."""
    if isinstance(tree, PackedLinear):
        return {f"{prefix}{k}": v for k, v in tree.state_dict().items()}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


def _server(cfg, tp, plan):
    return teng.InferenceServer(cfg, tp, plan=plan, max_len=32,
                                max_batch=2, cache="paged", page_size=8,
                                obs=tobs.Observability(), device="cpu")


@pytest.mark.parametrize("planned", [True, False])
def test_poison_trips_guard_undo_restores_and_spares_others(llama,
                                                            planned):
    cfg, tp, _ = llama
    plan = teng.synthetic_plan(cfg, tp, bits=None, seed=0) if planned \
        else None
    srv, other = _server(cfg, tp, plan), _server(cfg, tp, plan)
    req = TReq(uid=3, prompt=np.arange(1, 7, dtype=np.int32),
               sampling=TSP(max_tokens=5))
    want = other.serve([req])[3]
    before = {k: v.clone() for k, v in _flat(srv.params).items()}
    old = srv.params

    srv.begin([req])
    assert not srv.step().nan                       # admission + decode
    undo = tchaos.poison_params(srv)
    assert srv.params is not old
    poisoned = [k for k, v in _flat(srv.params).items()
                if v.is_floating_point() and torch.isnan(v).any()]
    assert len(poisoned) >= 1
    if planned:        # a packed projection's scales, nothing else
        assert all("/sw" in k for k in poisoned), poisoned
    assert srv.step().nan
    reg = srv.obs.registry
    assert reg.counter("fault_nan_detected_total").value() == 1
    srv.end()

    undo()
    assert srv.params is old
    after = _flat(srv.params)
    assert after.keys() == before.keys()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    # every tensor the two servers share was left as it was
    np.testing.assert_array_equal(other.serve([req])[3], want)
    # (``srv`` itself keeps the poisoned step's NaN K/V in its null page,
    # where its idle slot wrote, as the JAX package's server does: the
    # fleet's warm-up probe then fails and the replica stays down)


def test_poison_skips_fully_pruned_projections():
    """A PackedLinear with no precision group (every channel pruned) is
    passed over, as in the reference."""
    empty = PackedLinear((), torch.zeros(0, dtype=torch.int32), 4, 4)
    w = torch.ones(2, 4, 4)

    class Srv:
        params = {"blocks": ({"a": {"w": empty}, "b": {"w": w}},)}
    srv = Srv()
    undo = tchaos.poison_params(srv)
    blk = srv.params["blocks"][0]
    assert blk["a"]["w"] is empty and torch.isnan(blk["b"]["w"]).all()
    assert not torch.isnan(w).any()
    undo()
    assert srv.params["blocks"][0]["b"]["w"] is w


def test_corrupt_store_entry_raises(tmp_path, llama):
    from repro.serve import engine as jeng
    cfg, tp, (jcfg, jp) = llama
    plans = {"t": teng.synthetic_plan(cfg, tp, bits=8),
             "j": jeng.synthetic_plan(jcfg, jp, bits=8)}
    stores = {}
    for name, mod, chaos_mod in (("t", tsweep, tchaos),
                                 ("j", jsweep, jchaos)):
        store = mod.PlanStore(str(tmp_path / name))
        store.put(plans[name], "pt00", metrics={"score": 1.0},
                  costs={"size": 1.0})
        path = chaos_mod.corrupt_store_entry(store, "pt00")
        with open(path, "rb") as f:
            stores[name] = f.read()
        with pytest.raises(mod.StoreCorruptError):
            store.entry("pt00")
        with pytest.raises(FileNotFoundError):
            chaos_mod.corrupt_store_entry(store, "absent")
    assert stores["t"] == stores["j"]
    # the JAX package's corrupted store reads as corrupt in the port
    with pytest.raises(tsweep.StoreCorruptError):
        tsweep.PlanStore(str(tmp_path / "j")).entry("pt00")

