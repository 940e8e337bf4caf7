"""The port's serving stack against the JAX package's ``InferenceServer``
on the ``test_serve`` / ``test_cache`` workload (``llama3.2-1b-smoke``,
prompts of 6/14/9/21 tokens, 12 tokens each, ``max_len`` 48, pages of 8),
and the port's own invariants: dense == paged, batched == solo and
preempted-then-resumed == uninterrupted, token for token."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro.configs import registry
from repro.models import lm as jlm
from repro.serve import engine as jeng
from repro.serve.sampling import SamplingParams as JSP
from repro.serve.scheduler import Request as JReq
from repro_torch.bridge import params_from_jax
from repro_torch.serve import engine as teng
from repro_torch.serve.sampling import SamplingParams as TSP
from repro_torch.serve.scheduler import Request as TReq
from torch_threads import _one_torch_thread  # noqa: F401

LENS = (6, 14, 9, 21)
KW = dict(max_len=48, max_batch=2)
PAGED = dict(cache="paged", page_size=8)
GREEDY = dict(max_tokens=12)
HOST = dict(temperature=0.8, top_k=12, max_tokens=12, seed=11)
PAGE_KEYS = ("peak_pages_in_use", "pages_in_use", "n_pages")


def _prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, size=s).astype(np.int32)
            for s in LENS]


def _serve(server, req_cls, sp, prompts, uids=None):
    uids = range(len(prompts)) if uids is None else uids
    return server.serve([req_cls(uid=i, prompt=prompts[i], sampling=sp)
                         for i in uids])


@pytest.fixture(scope="module")
def world():
    """Both packages' weights and the JAX reference runs (paged; the JAX
    package's own tests hold its dense and paged streams equal)."""
    cfg = registry.get("llama3.2-1b-smoke")
    jp = jlm.init_params(cfg, jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    prompts = _prompts(cfg)
    ref = {}
    for name, plan, sp, on_dev in (
            ("greedy", None, GREEDY, True), ("host", None, HOST, False),
            ("plan", jeng.synthetic_plan(cfg, jp, bits=None, seed=0),
             GREEDY, True)):
        srv = jeng.InferenceServer(cfg, jp, plan=plan,
                                   sample_on_device=on_dev, **KW, **PAGED)
        out = _serve(srv, JReq, JSP(**sp), prompts)
        ref[name] = (out, {k: srv.stats["memory"][k] for k in PAGE_KEYS})
    return cfg, tp, prompts, ref


def _port(cfg, tp, cache, plan=None, sample_on_device=True, **extra):
    kw = dict(KW, **(PAGED if cache == "paged" else {}), **extra)
    return teng.InferenceServer(cfg, tp, plan=plan, device="cpu",
                                sample_on_device=sample_on_device, **kw)


@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["greedy", "host"])
def test_float_streams_equal_jax(world, cache, mode):
    cfg, tp, prompts, ref = world
    sp = GREEDY if mode == "greedy" else HOST
    srv = _port(cfg, tp, cache, sample_on_device=mode == "greedy")
    out = _serve(srv, TReq, TSP(**sp), prompts)
    want, mem = ref[mode]
    for i in range(len(LENS)):
        np.testing.assert_array_equal(out[i], want[i])
    if cache == "paged":
        assert {k: srv.stats["memory"][k] for k in PAGE_KEYS} == mem


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_plan_streams_against_jax(world, cache):
    """Plan-bound greedy streams equal the JAX package's, all four
    requests, dense and paged.  This needs XLA's numerics in the per-row
    int8 activation quantization: under ``jax.jit`` the scale
    ``absmax / 127`` is ``absmax * f32(1/127)`` (a division by a constant
    becomes a multiplication by its reciprocal), and an ulp in the scale
    can turn ``x / sx`` into another integer (ROADMAP queue 3)."""
    cfg, tp, prompts, ref = world
    plan = teng.synthetic_plan(cfg, tp, bits=None, seed=0)
    srv = _port(cfg, tp, cache, plan=plan)
    out = _serve(srv, TReq, TSP(**GREEDY), prompts)
    want, mem = ref["plan"]
    same = [np.array_equal(out[i], want[i]) for i in range(len(LENS))]
    assert same == [True, True, True, True], same
    if cache == "paged":
        assert {k: srv.stats["memory"][k] for k in PAGE_KEYS} == mem


@pytest.mark.parametrize("planned", [False, True])
def test_port_invariants(world, planned):
    """Within the port, bitwise: dense == paged, batched == solo, and a
    pool small enough to force preemption == uninterrupted."""
    cfg, tp, prompts, _ = world
    plan = teng.synthetic_plan(cfg, tp, bits=None, seed=0) if planned \
        else None
    sp = TSP(**GREEDY)
    dense = _serve(_port(cfg, tp, "dense", plan=plan), TReq, sp, prompts)
    paged = _serve(_port(cfg, tp, "paged", plan=plan), TReq, sp, prompts)
    solo_srv = _port(cfg, tp, "paged", plan=plan)
    tiny = _port(cfg, tp, "paged", plan=plan, pages=6)
    pre = _serve(tiny, TReq, sp, prompts)
    assert tiny.stats["preemptions"] > 0
    assert tiny.stats["memory"]["pages_in_use"] == 0
    for i in range(len(LENS)):
        solo = _serve(solo_srv, TReq, sp, prompts, uids=[i])
        for other in (paged, solo, pre):
            np.testing.assert_array_equal(other[i], dense[i])


def test_host_sampling_preempted_equals_uninterrupted(world):
    cfg, tp, prompts, _ = world
    sp = TSP(**HOST)
    full = _serve(_port(cfg, tp, "paged", sample_on_device=False), TReq,
                  sp, prompts)
    tiny = _port(cfg, tp, "paged", sample_on_device=False, pages=6)
    pre = _serve(tiny, TReq, sp, prompts)
    assert tiny.stats["preemptions"] > 0
    for i in range(len(LENS)):
        np.testing.assert_array_equal(pre[i], full[i])
