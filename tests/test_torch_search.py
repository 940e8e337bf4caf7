"""The port's joint search (``repro_torch`` core/, models/cnn, data/,
api/) against the JAX package on the CPU, values and gradients against
``jax.grad`` on the same inputs (bridged with ``repro_torch.bridge``).

The JAX side runs under ``jax.jit``, as the reference's search steps
do: XLA then multiplies by the float32 reciprocal of a constant divisor,
which the port mirrors (``core.quantizers.recip``).

Stated tolerances, and why:
* quantizers, samplers, effective weights and cost models: rtol 1e-5
  (values) and 1e-4 (gradients), atol 1e-6 scaled by the tensor's
  magnitude -- float32 ops in another order;
* ``cnn.apply``: logits within 1e-4 in float mode; in search and quant
  modes within 3e-2, because a PACT-quantized activation that lies
  within a rounding of a grid boundary may land one 8-bit step
  (alpha / 255 = 0.024) apart; gradients within 2e-2 of the largest;
* ``class_batch``: labels equal, images within 1e-5 (the normal draw is
  within 4 ULPs, the resize weights are recomputed in float32);
End to end: ``test_torch_search_e2e.py`` and
``test_torch_search_clips.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro import api as japi
from repro.core import costs as jcosts
from repro.core import mps as jmps
from repro.core import quantizers as jq
from repro.core import sampling as jsamp
from repro.data import synthetic as jsyn
from repro.models import cnn as jcnn
from repro_torch.api import compressor as tcomp
from repro_torch.api import cost_models as tcm
from repro_torch.api import phases as tph
from repro_torch.core import costs as tcosts
from repro_torch.core import mps as tmps
from repro_torch.core import quantizers as tq
from repro_torch.core import rng as trng
from repro_torch.core import sampling as tsamp
from repro_torch.data import synthetic as tsyn
from repro_torch.models import cnn as tcnn
from torch_threads import _one_torch_thread  # noqa: F401

PW = (0, 2, 4, 8)
PX = (8,)


def _t(a):
    return torch.tensor(np.array(a))


def _close(got, want, rtol, atol=1e-6):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _tgrad(fn, *args):
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, allow_unused=True)
    return out.detach(), [g if g is not None else torch.zeros_like(x)
                          for g, x in zip(grads, leaves)]


# ---------------------------------------------------------------- quantizers
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_weight_quantizer_values_and_grads(bits):
    rng = np.random.default_rng(bits)
    w = rng.normal(size=(6, 3, 3, 3)).astype(np.float32)
    # scale rows 0-2 to an absmax whose ratio absmax / scale rounds back
    # to qmax, so their absmax element ties with the clip bound
    qmax = np.float32(2 ** (bits - 1) - 1)
    cand = np.linspace(0.5, 2.0, 257, dtype=np.float32)
    tied = cand[cand / (cand * (np.float32(1) / qmax)) == qmax]
    w[:3] *= tied[0] / np.abs(w[:3]).reshape(3, -1).max(1)[:, None, None,
                                                          None]
    w[4] = 0.0                                    # an all-zero channel
    up = rng.normal(size=w.shape).astype(np.float32)

    def jf(w):
        return jnp.sum(jq.quantize_weights_symmetric(w, bits, 0) * up)

    def tf(w):
        return torch.sum(tq.quantize_weights_symmetric(w, bits, 0)
                         * _t(up))

    want, jg = jax.jit(jax.value_and_grad(jf))(w)
    got, (tg,) = _tgrad(tf, _t(w))
    _close(got, want, 1e-5)
    _close(tg, jg, 1e-4)
    # gradient 0.5 on the tie
    flat = w.reshape(6, -1)
    scale = np.maximum(np.abs(flat).max(1, keepdims=True),
                       np.float32(1e-8)) * (np.float32(1) / qmax)
    tie = np.abs(flat / scale) == qmax
    assert tie.any()
    np.testing.assert_allclose(tg.numpy().reshape(6, -1)[tie],
                               0.5 * up.reshape(6, -1)[tie], rtol=1e-6)


def test_clip_splits_ties_like_jax():
    x = np.array([-1.0, -0.5, 0.0, 0.3, 1.0, 2.0], np.float32)
    jg = jax.jit(jax.grad(lambda x: jnp.sum(jnp.clip(x, -1.0, 1.0))))(x)
    _, (tg,) = _tgrad(lambda x: torch.sum(tq.clip(x, -1.0, 1.0)), _t(x))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert tg[0] == 0.5 and tg[4] == 0.5


@pytest.mark.parametrize("bits", [2, 4, 8, 32])
def test_pact_values_and_grads(bits):
    rng = np.random.default_rng(bits)
    x = (rng.normal(size=(4, 5, 6)) * 3).astype(np.float32)
    x[0, 0, :3] = (0.0, 2.5, -1.0)                 # ties at 0 and alpha
    alpha = np.float32(2.5)
    up = rng.normal(size=x.shape).astype(np.float32)

    def jf(x, a):
        return jnp.sum(jq.pact_quantize(x, a, bits) * up)

    def tf(x, a):
        return torch.sum(tq.pact_quantize(x, a, bits) * _t(up))

    want, (jgx, jga) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(
        x, alpha)
    got, (tgx, tga) = _tgrad(tf, _t(x), _t(alpha))
    _close(got, want, 1e-5)
    _close(tgx, jgx, 1e-4)
    _close(tga, jga, 1e-4)


def test_ste_round_and_multi_stacks():
    x = np.linspace(-3, 3, 25).astype(np.float32)
    np.testing.assert_array_equal(tq.ste_round(_t(x)).numpy(),
                                  np.asarray(jax.jit(jq.ste_round)(x)))
    w = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        tq.quantize_weights_multi(_t(w), PW).numpy(),
        np.asarray(jax.jit(lambda w: jq.quantize_weights_multi(w, PW))(w)))
    # a trained clip (a traced argument in the reference's step) and a
    # fixed one (a constant XLA folds, as in quant mode)
    np.testing.assert_array_equal(
        tq.quantize_acts_multi(_t(w), _t(np.float32(1.5)), (2, 4, 8)).numpy(),
        np.asarray(jax.jit(lambda w, a: jq.quantize_acts_multi(
            w, a, (2, 4, 8)))(w, np.float32(1.5))))
    np.testing.assert_array_equal(
        tq.quantize_acts_multi(_t(w), 1.5, (2, 4, 8)).numpy(),
        np.asarray(jax.jit(lambda w: jq.quantize_acts_multi(
            w, 1.5, (2, 4, 8)))(w)))


# ------------------------------------------------------------------ samplers
@pytest.mark.parametrize("method", jsamp.SAMPLERS)
def test_samplers_values_and_grads(method):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(7, 4)).astype(np.float32)
    up = rng.normal(size=logits.shape).astype(np.float32)
    jkey, tkey = jax.random.key(5), trng.key(5)

    want, jg = jax.jit(jax.value_and_grad(lambda l: jnp.sum(
        jsamp.sample(l, method, 0.7, jkey) * up)))(logits)
    got, (tg,) = _tgrad(lambda l: torch.sum(
        tsamp.sample(l, method, 0.7, tkey) * _t(up)), _t(logits))
    _close(got, want, 1e-5)
    _close(tg, jg, 1e-4)
    np.testing.assert_array_equal(
        tsamp.init_selection_logits(PW, (3,)).numpy(),
        np.asarray(jsamp.init_selection_logits(PW, (3,))))
    sched_j = jsamp.temperature_schedule(1.0, 0.638)
    sched_t = tsamp.temperature_schedule(1.0, 0.638)
    _close(sched_t(3), sched_j(3), 1e-6)


# --------------------------------------------------------- effective weight
@pytest.mark.parametrize("path", ["plain", "k4_ref"])
@pytest.mark.parametrize("shape", [(8, 3, 3, 3), (12, 20), (1, 9)])
def test_effective_weight_both_paths(path, shape):
    """The plain quantizer stack and kernel K4's plain version through
    its ``autograd.Function`` (``use_kernel=True`` on CPU tensors),
    against ``jax.grad`` of the reference's ``effective_weight``."""
    rng = np.random.default_rng(sum(shape))
    w = rng.normal(size=shape).astype(np.float32)
    gamma = rng.normal(size=(shape[0], len(PW))).astype(np.float32)
    up = rng.normal(size=shape).astype(np.float32)
    jctx = jmps.SearchCtx(jsamp.SOFTMAX, 0.8)
    tctx = tmps.SearchCtx(tsamp.SOFTMAX, 0.8,
                          use_kernel=path == "k4_ref")

    want, jg = jax.jit(jax.value_and_grad(
        lambda w, g: jnp.sum(jmps.effective_weight(w, g, PW, jctx) * up),
        argnums=(0, 1)))(w, gamma)
    got, tg = _tgrad(lambda w, g: torch.sum(
        tmps.effective_weight(w, g, PW, tctx) * _t(up)), _t(w), _t(gamma))
    _close(got, want, 1e-5)
    _close(tg[0], jg[0], 1e-4)
    _close(tg[1], jg[1], 1e-4)


def test_k4_function_matches_jax_custom_vjp():
    """``ops.mps_combine`` (plain forward on the CPU, closed-form
    backward) against the reference's ``mps_combine`` custom VJP."""
    from repro.kernels.mps_combine import ops as jops
    from repro_torch.kernels.mps_combine import ops as tops
    rng = np.random.default_rng(11)
    w = rng.normal(size=(16, 40)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(rng.normal(size=(16, 4)), axis=-1),
                       np.float32)
    up = rng.normal(size=w.shape).astype(np.float32)
    want, jg = jax.jit(jax.value_and_grad(
        lambda w, p: jnp.sum(jops.mps_combine(w, p, PW) * up),
        argnums=(0, 1)))(w, probs)
    got, tg = _tgrad(lambda w, p: torch.sum(
        tops.mps_combine(w, p, PW) * _t(up)), _t(w), _t(probs))
    _close(got, want, 1e-5)
    _close(tg[0], jg[0], 1e-4)
    _close(tg[1], jg[1], 1e-4)
    # the forward is the plain version, bitwise; the counter is untouched
    before = tops.mps_combine_fwd.launches
    np.testing.assert_array_equal(
        tops.mps_combine_fwd(_t(w), _t(probs), PW).numpy(),
        tops.mps_combine_ref(_t(w), _t(probs), PW).numpy())
    assert tops.mps_combine_fwd.launches == before


def test_mps_helpers():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(6, 4, 3, 3)).astype(np.float32)
    gamma = rng.normal(size=(6, 4)).astype(np.float32)
    jctx = jmps.SearchCtx(jsamp.SOFTMAX, 0.5)
    tctx = tmps.SearchCtx(tsamp.SOFTMAX, 0.5)
    _close(tmps.rescale_weights_for_search(_t(w), _t(gamma), PW, tctx),
           jmps.rescale_weights_for_search(w, gamma, PW, jctx), 1e-5)
    _close(tmps.expected_bits(_t(gamma), PW, tctx),
           jmps.expected_bits(gamma, PW, jctx), 1e-5)
    _close(tmps.keep_probability(_t(gamma), PW, tctx),
           jmps.keep_probability(gamma, PW, jctx), 1e-5)
    np.testing.assert_array_equal(tmps.discretize_gamma(_t(gamma), PW),
                                  jmps.discretize_gamma(gamma, PW))
    assert tmps.discretize_delta(_t(gamma[0]), PW) == \
        jmps.discretize_delta(gamma[0], PW)


# --------------------------------------------------------------- cost models
@pytest.mark.parametrize("model", jcosts.COST_MODELS)
@pytest.mark.parametrize("graph", ["dscnn", "resnet9"])
def test_cost_models_values_and_grads(model, graph):
    g = jcnn.dscnn(width=8) if graph == "dscnn" else jcnn.resnet9(width=4)
    geoms = jcnn.cost_geoms(g)
    tgeoms = tcnn.cost_geoms(tcnn.CNN_BUILDERS[graph](
        **({"width": 8} if graph == "dscnn" else {"width": 4})))
    assert [dataclasses.astuple(a) for a in geoms] == \
        [dataclasses.astuple(b) for b in tgeoms]
    mp = jcnn.init_mps_params(g, PW, (2, 4, 8))
    rng = np.random.default_rng(len(model))
    gam = {k: np.asarray(v) + rng.normal(size=v.shape).astype(np.float32)
           for k, v in mp["gamma"].items()}
    dl = {k: rng.normal(size=v.shape).astype(np.float32)
          for k, v in mp["delta"].items()}
    jctx = jmps.SearchCtx(jsamp.SOFTMAX, 0.6)
    tctx = tmps.SearchCtx(tsamp.SOFTMAX, 0.6)
    want, (jgg, jgd) = jax.jit(jax.value_and_grad(
        lambda gm, d: jcosts.total_cost(geoms, gm, d, PW, (2, 4, 8), jctx,
                                        model), argnums=(0, 1)))(gam, dl)
    tgam = {k: _t(v).requires_grad_(True) for k, v in gam.items()}
    tdl = {k: _t(v).requires_grad_(True) for k, v in dl.items()}
    got = tcosts.total_cost(tgeoms, tgam, tdl, PW, (2, 4, 8), tctx, model)
    grads = torch.autograd.grad(got, list(tgam.values()) + list(tdl.values()),
                                allow_unused=True)
    _close(got, want, 1e-5)
    wants = [jgg[k] for k in tgam] + [jgd[k] for k in tdl]
    for gr, ref, leaf in zip(grads, wants,
                             list(tgam.values()) + list(tdl.values())):
        _close(gr if gr is not None else torch.zeros_like(leaf), ref, 1e-4)
    # the discrete face, on one concrete assignment
    cm_t, cm_j = tcm.get_cost_model(model), japi.get_cost_model(model)
    for geom in geoms:
        bits = np.asarray(PW)[rng.integers(0, 4, size=geom.cout)]
        assert cm_t.discrete(geom, bits, geom.cin / 2) == pytest.approx(
            cm_j.discrete(geom, bits, geom.cin / 2), rel=1e-12)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("name", ["cifar10", "gsc", "tinyimagenet"])
def test_class_batch_matches_jax(name):
    for step in (0, 7):
        jx, jy = jsyn.class_batch(jsyn.DATASETS[name], step, 8, seed=3)
        tx, ty = tsyn.class_batch(tsyn.DATASETS[name], step, 8, seed=3)
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)


def test_compressor_refuses_cpu_fallback_and_checkpoint():
    g = tcnn.dscnn(width=8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcomp.Compressor(g, tsyn.GSC_LIKE)
    comp = tcomp.Compressor(g, tsyn.GSC_LIKE, batch=8, device="cpu")
    # checkpoint= (tests/test_torch_compressor_resume.py) and the metrics
    # registry are both taken
    from repro_torch.obs import MetricsRegistry
    reg = MetricsRegistry()
    comp.run([tph.Warmup(steps=1)], registry=reg)
    assert "compress_phase_seconds" in reg.snapshot()
