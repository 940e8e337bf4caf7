"""The port's search end to end against the JAX package on the CPU:
Warmup -> JointSearch -> Finetune in both packages from the same
(bridged) initial parameters, at batch 8, compared by their plans."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro import api as japi
from repro.data import synthetic as jsyn
from repro.models import cnn as jcnn
from repro_torch.api import compressor as tcomp
from repro_torch.api import phases as tph
from repro_torch.api.plan import CompressionPlan as TPlan
from repro_torch.bridge import cnn_params_from_jax
from repro_torch.data import synthetic as tsyn
from repro_torch.models import cnn as tcnn
from torch_threads import _one_torch_thread  # noqa: F401


class _SetParams(japi.Hook):
    """Start Warmup from given parameters (either package's hooks)."""

    def __init__(self, params):
        self.params = params

    def on_phase_start(self, phase, state):
        if phase.name == "warmup":
            state.params = self.params


class _TSetParams(_SetParams, tph.Hook):
    pass


def run_both(graph, spec, px, steps, lam, registries=(None, None)):
    """Warmup -> JointSearch -> Finetune in both packages from the same
    (bridged) initial parameters, at batch 8; returns both results.
    ``registries`` (JAX's, the port's) also log every step's metrics
    into the packages' metrics registries."""
    g, tg = graph(jcnn), graph(tcnn)
    jp = jcnn.init_params(g, jax.random.key(0))
    w, s, f = steps
    jreg, treg = registries
    quiet = lambda line: None
    jr = japi.Compressor(g, getattr(jsyn, spec), px=px, batch=8,
                         seed=0).run(
        [japi.Warmup(steps=w), japi.JointSearch(steps=s, lam=lam),
         japi.Finetune(steps=f)],
        hooks=[_SetParams(jp)] + ([japi.MetricsLog(every=1, printer=quiet)]
                                  if jreg is not None else []),
        registry=jreg)
    tr = tcomp.Compressor(tg, getattr(tsyn, spec), px=px, batch=8, seed=0,
                          device="cpu").run(
        [tph.Warmup(steps=w), tph.JointSearch(steps=s, lam=lam),
         tph.Finetune(steps=f)],
        hooks=[_TSetParams(cnn_params_from_jax(
            jax.tree.map(np.asarray, jp)))]
        + ([tph.MetricsLog(every=1, printer=quiet)] if treg is not None
           else []),
        registry=treg)
    return jr, tr, TPlan.from_tree(jr.plan.to_tree(), jr.plan.scalars())


@pytest.fixture(scope="module")
def dscnn_runs():
    """dscnn width 8 on GSC_LIKE, warmup 2 / search 3 / finetune 2
    steps, lambda 1e4, every step's metrics logged into each package's
    registry."""
    from repro.obs import MetricsRegistry as JRegistry
    from repro_torch.obs import MetricsRegistry as TRegistry
    regs = (JRegistry(), TRegistry())
    return run_both(lambda m: m.dscnn(width=8), "GSC_LIKE", (32,),
                    (2, 3, 2), 1e4, registries=regs) + regs


def test_compressor_plan_equals_jax(dscnn_runs):
    """dscnn width 8 on GSC_LIKE, warmup 2 / search 3 / finetune 2 steps,
    pw (0, 2, 4, 8), lambda 1e4 (a plan that prunes and mixes
    precisions): the port's plan ``equals`` the JAX package's -- bits,
    Fig. 3 permutations, activation bits and clips.

    Activations stay float (px = (32,)), so the PACT clips take no
    gradient and keep their initial value in both packages.  A trained
    clip is a sum of many rounding-sized terms and lands some ULPs apart
    (``test_torch_search_clips`` holds that case within a tolerance).
    Accuracies agree within 0.04: after 7 steps the networks are near
    chance, where near-tied logits flip, and Finetune's first Adam step
    moves every weight by ``lr`` in the sign of a gradient that may be
    rounding noise (observed up to 0.018 across Python's per-process
    string hashes, which pick the data's class templates)."""
    jr, tr, jplan, _, _ = dscnn_runs
    assert tr.plan.equals(jplan)
    assert 0 < tr.prune_fraction < 1
    assert tr.size_bytes == pytest.approx(jr.size_bytes, rel=1e-12)
    assert tr.bits_histogram == jr.bits_histogram
    assert tr.acc_float == pytest.approx(jr.acc_float, abs=0.04)
    assert tr.acc_final == pytest.approx(jr.acc_final, abs=0.04)


def test_compressor_registry_matches_jax(dscnn_runs):
    """``run(registry=)``: the same metric families, labels and point
    counts as the JAX package's; the step values (losses, accuracies)
    within the run's own tolerance (the packages' rounding differs)."""
    _, _, _, jreg, treg = dscnn_runs
    js, ts = jreg.snapshot(), treg.snapshot()
    assert ts.keys() == js.keys()
    for name in js:
        assert (ts[name]["kind"], ts[name]["labels"]) == \
            (js[name]["kind"], js[name]["labels"]), name
        assert [s["labels"] for s in ts[name]["series"]] == \
            [s["labels"] for s in js[name]["series"]], name
    assert ts["compress_step_points_total"] == \
        js["compress_step_points_total"]
    phases = {s["labels"]["phase"]
              for s in ts["compress_phase_seconds"]["series"]}
    assert phases == {"warmup", "search", "finetune"}
