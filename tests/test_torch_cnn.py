"""The port's graph-interpreted CNNs (``repro_torch.models.cnn``)
against the JAX package's on the CPU: He init from the threefry stream,
BN folding, and ``cnn.apply`` in float, search and quant modes for the
three reference graphs at small size (resnet18 at its published widths,
forward only, batch 2), values and gradients against ``jax.grad``
under ``jax.jit``.

Tolerances: logits within 1e-4 in float mode; in search and quant modes
within 3e-2, because a PACT-quantized activation that lies within a
rounding of a grid boundary may land one 8-bit step (alpha / 255 =
0.024) apart; gradients within 2e-2 of the largest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro.core import mps as jmps
from repro.core import sampling as jsamp
from repro.data import synthetic as jsyn
from repro.models import cnn as jcnn
from repro_torch.api import phases as tph
from repro_torch.bridge import (cnn_params_from_jax, mps_params_from_jax,
                                tree_to_numpy)
from repro_torch.core import mps as tmps
from repro_torch.core import rng as trng
from repro_torch.core import sampling as tsamp
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


GRAPHS = {"dscnn": (lambda m: m.dscnn(width=8), "GSC_LIKE", 8),
          "resnet9": (lambda m: m.resnet9(width=4), "CIFAR10_LIKE", 8),
          "resnet18": (lambda m: m.resnet18(), "TINYIMAGENET_LIKE", 2)}
_WORLDS: dict = {}


def _jax_to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _trained_bn(params):
    """``params`` with BN running statistics drawn from a seed, as a
    trained network has them.  At init they are 0 and 1 and every bias is
    0, so the folded biases are exactly 0; with 2-bit weights and
    PACT-quantized inputs many pre-activations then sum to exactly 0, a
    tie with PACT's lower bound whose 0.5 gradient turns on the
    convolution's summation order (XLA's and oneDNN's differ in a few
    elements per layer).  The tie's gradient itself is held in
    ``test_torch_search.py``.  Float mode normalizes with the batch's
    statistics and does not read these."""
    rng = np.random.default_rng(1)
    out = {}
    for name, p in params.items():
        p = dict(p)
        if "bn" in p:
            c = np.asarray(p["bn"]["mean"]).shape[0]
            p["bn"] = dict(p["bn"],
                           mean=jnp.asarray(rng.normal(0.0, 0.1, c),
                                            jnp.float32),
                           var=jnp.asarray(rng.uniform(0.5, 1.5, c),
                                           jnp.float32))
        out[name] = p
    return out


def _world(graph):
    """Both packages' graph, bridged parameters (raw and BN-folded),
    selection parameters and one batch, built once per graph."""
    if graph not in _WORLDS:
        build, spec_name, batch = GRAPHS[graph]
        g, tg = build(jcnn), build(tcnn)
        jinit = jax.jit(lambda k: jcnn.init_params(g, k))(jax.random.key(0))
        jp = _trained_bn(jinit)
        tp = cnn_params_from_jax(_jax_to_np(jp))
        jf = jcnn.fold_batchnorm(g, jp)
        mp = jcnn.init_mps_params(g, PW, PX)
        x, y = jsyn.class_batch(getattr(jsyn, spec_name), 0, batch)
        _WORLDS[graph] = dict(
            g=g, tg=tg, batch=batch, x=x, y=y, mp=mp, init=jinit,
            params={False: jp, True: jf},
            tparams={False: tp, True: tcnn.fold_batchnorm(tg, tp)},
            tmp=mps_params_from_jax(_jax_to_np(mp)))
    return _WORLDS[graph]


@pytest.mark.parametrize("graph", ["dscnn", "resnet9"])
def test_init_and_fold_match_jax(graph):
    """The port's He init draws the reference's numbers (the normal
    within 4 ULPs); BN folding agrees to float32 rounding."""
    wd = _world(graph)
    tp = tcnn.init_params(wd["tg"], trng.key(0))
    for k, p in wd["init"].items():
        _close(tp[k]["w"], p["w"], 1e-5)
        for leaf in ("b", "bn"):
            if leaf in p:
                np.testing.assert_array_equal(
                    np.asarray(jax.tree.leaves(p[leaf])),
                    np.asarray([t.numpy() for t in (
                        [tp[k][leaf]] if leaf == "b" else
                        [tp[k]["bn"][n] for n in sorted(tp[k]["bn"])])]
                    ).reshape(np.asarray(jax.tree.leaves(p[leaf])).shape))
    folded = tree_to_numpy(wd["tparams"][True])
    for k, p in wd["params"][True].items():
        _close(folded[k]["w"], p["w"], 1e-6)
        _close(folded[k]["b"], p["b"], 1e-6)


@pytest.mark.parametrize("mode", ["float", "search", "quant"])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_cnn_apply_three_modes(graph, mode):
    wd = _world(graph)
    g, tg, batch, x, y = wd["g"], wd["tg"], wd["batch"], wd["x"], wd["y"]
    folded = mode != "float"
    jp, tp = wd["params"][folded], wd["tparams"][folded]
    mp, tmp = wd["mp"], wd["tmp"]
    tx = _t(x)
    rng = np.random.default_rng(0)
    assignment = {"gamma": {k: np.asarray(PW)[rng.integers(
                      1, 4, size=v.shape[0])] for k, v in mp["gamma"].items()},
                  "delta": {k: 8 for k in mp["delta"]},
                  "alpha": {k: 4.0 for k in mp["alpha"]}}
    kw = dict(mode=mode, folded=folded, pw=PW, px=PX, assignment=assignment)
    jctx = jmps.SearchCtx(jsamp.SOFTMAX, 1.0)
    tctx = tmps.SearchCtx(tsamp.SOFTMAX, 1.0)

    def jloss(p, m):
        logits, _ = jcnn.apply(g, p, x, mps_params=m, ctx=jctx, train=True,
                               **kw)
        return jnp.sum(jax.nn.log_softmax(logits)[jnp.arange(batch), y]), \
            logits

    def tloss(p, m):
        logits, _ = tcnn.apply(tg, p, tx, mps_params=m, ctx=tctx,
                               train=True, **kw)
        lp = torch.log_softmax(logits, -1)
        return torch.sum(lp[torch.arange(batch), _t(y).long()]), logits

    tol = 1e-4 if mode == "float" else 3e-2
    if graph == "resnet18":                  # forward only
        with torch.no_grad():
            _, tl = tloss(tp, tmp)
        _, jl = jax.jit(jloss)(jp, mp)
        assert tl.shape == (batch, 200) and torch.isfinite(tl).all()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
        return
    (jv, jl), (jgp, jgm) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, mp)
    tv, tl, tgr = tph.value_and_grad(lambda sp: tloss(sp["p"], sp["m"]),
                                     {"p": tp, "m": tmp})
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=tol)
    for name in jgp:
        for leaf in ("w", "b"):
            want = np.asarray(jgp[name][leaf])
            got = tgr["p"][name][leaf].numpy()
            np.testing.assert_allclose(
                got, want, atol=2e-2 * max(np.abs(want).max(), 1e-3))
    if mode == "search":
        for k, v in jgm["gamma"].items():
            want = np.asarray(v)
            np.testing.assert_allclose(
                tgr["m"]["gamma"][k].numpy(), want,
                atol=2e-2 * max(np.abs(want).max(), 1e-3))


