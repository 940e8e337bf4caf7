"""Mamba-2 training under the paper's joint search in the port (K5's
backward, ``nn/blocks.mamba2_layer(mode="train")``, ``models/lm`` and
``launch/steps`` / ``launch/train`` on a Mamba-2 stack) against the JAX
package on the CPU, from numpy-seeded inputs, with the reference's
parameters carried across (``bridge.lm_params_from_jax``) and the JAX side
under ``jax.jit``, as its training step runs.

Tolerances, and why:

* K5's backward (``ssd_scan_bwd_ref``) against ``jax.vjp`` of the JAX
  package's ``ssd_scan_ref``: rtol 1e-6 (measured at most 1.9e-7 of the
  largest magnitude: XLA contracts the reverse step's multiply and add
  into an FMA, and ``ddecay`` sums its P * N products in another order);
  the autograd function's CPU gradient against torch autograd through
  the plain forward: bitwise;
* the softplus gradient against ``jax.grad(jax.nn.softplus)``: rtol 1e-6
  (JAX's ``exp(x - softplus(x))`` with torch's ``exp``; measured one ULP
  at +-1e-3, equal elsewhere);
* the ``mamba2-780m-smoke`` loss under the search: rtol 2e-5 (measured
  4.8e-6: bf16 compute rounded at other places); ``mps_size_cost``: rtol
  1e-6 (float32 sums in another order);
* every leaf's gradient: relative L2 within 3e-2, the bound of the dense
  family in ``tests/test_torch_train.py`` (measured at most 1.7e-2, the
  conv kernels' and ``d_skip``'s small gradients summed over bf16
  products; the embedding's 1.0e-2 is its f32 sum here against bf16
  there);
* three ``make_train_step`` steps (Adam at 3e-4): losses rtol 2e-4, each
  update within ``6 * lr`` of the reference's and within relative L2
  0.15 of it over each leaf (Adam moves an entry by ~lr whatever its
  gradient's size), the bounds of ``tests/test_torch_train.py``.
"""
import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro.configs import registry as jreg
from repro.core import mps as jmps
from repro.data import synthetic as jsyn
from repro.kernels.ssd_scan import ref as jssd_ref
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import registry as treg
from repro_torch.core import mps as tmps
from repro_torch.kernels.ssd_scan import ops as tssd
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.nn import blocks as tb
from repro_torch.optim import grad as tgrad
from repro_torch.optim import optimizers as topt
from torch_threads import _one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "mamba2-780m-smoke"
LAM = 1e-6


def _flat(tree, prefix=""):
    """``{"a/b": numpy}`` of a JAX or port tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if torch.is_tensor(tree):
        return {prefix[:-1]: tree.detach().numpy()}
    return {prefix[:-1]: np.asarray(tree)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batch(cfg, step, batch=2, seq=65):
    """64 tokens: two chunks of 32, so K5 and its backward scan."""
    jb = jsyn.lm_batch(cfg.vocab, seq, batch, step)
    return jb, {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = jreg.get(ARCH), treg.get(ARCH)
    jp = jlm.init_params(jcfg, jax.random.key(0), mps_on=True)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg=tcfg)
    return jcfg, tcfg, jp, tp


# ---------------------------------------------------------------------------
# K5's backward
# ---------------------------------------------------------------------------

def _scan_case(c, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.3, 1.0, size=(c, h)).astype(np.float32),
            rng.normal(size=(c, h, p, n)).astype(np.float32),
            rng.normal(size=(h, p, n)).astype(np.float32),
            rng.normal(size=(c, h, p, n)).astype(np.float32),
            rng.normal(size=(h, p, n)).astype(np.float32))


@pytest.mark.parametrize("c,h,p,n", [(5, 3, 4, 8), (4, 2, 3, 5)])
@pytest.mark.parametrize("with_final", [True, False])
def test_ssd_scan_bwd_ref_matches_jax_vjp(c, h, p, n, with_final):
    """``ssd_scan_bwd_ref`` against ``jax.vjp`` of the reference's scan,
    with and without a cotangent for ``final`` (P * N = 15 is no
    multiple of 4: the kernel's one-float path)."""
    dec, s_in, s0, dprefix, dfinal = _scan_case(c, h, p, n, seed=c * n)
    if not with_final:
        dfinal = np.zeros_like(dfinal)
    (jpre, _), vjp = jax.vjp(jssd_ref.ssd_scan_ref, *map(jnp.asarray,
                                                         (dec, s_in, s0)))
    want = vjp((jnp.asarray(dprefix), jnp.asarray(dfinal)))
    prefix = torch.tensor(np.asarray(jpre))
    got = tssd.ssd_scan_bwd(torch.as_tensor(dec), prefix,
                            torch.as_tensor(dprefix),
                            torch.as_tensor(dfinal) if with_final else None)
    for g, w, what in zip(got, want, ("ddecay", "ds_in", "ds0")):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=what)


def test_ssd_scan_autograd_matches_plain_autograd():
    """The autograd function's CPU backward (the plain reverse
    recurrence) equals torch autograd through the plain forward written
    out, bit for bit; an unused ``final`` or ``prefix`` counts as
    zeros; the CPU counts no launch."""
    dec, s_in, s0, wp, wf = map(torch.as_tensor, _scan_case(5, 3, 4, 8, 1))

    def plain(d, x, s):
        pre = []
        for c in range(x.shape[0]):
            pre.append(s)
            s = d[c][:, None, None] * s + x[c]
        return torch.stack(pre), s

    before = tssd.ssd_scan.launches, tssd.ssd_scan_bwd.launches
    for use in ("both", "prefix", "final"):
        grads = []
        for fn in (tssd.ssd_scan, plain):
            args = [t.clone().requires_grad_() for t in (dec, s_in, s0)]
            pre, fin = fn(*args)
            loss = {"both": (pre * wp).sum() + (fin * wf).sum(),
                    "prefix": (pre * wp).sum(),
                    "final": (fin * wf).sum()}[use]
            loss.backward()
            grads.append([a.grad for a in args])
        for g, w in zip(*grads):
            assert torch.equal(g, w), use
    assert (tssd.ssd_scan.launches, tssd.ssd_scan_bwd.launches) == before
    with pytest.raises(ValueError, match="contiguous"):
        tssd.ssd_scan_bwd(dec, s_in.transpose(2, 3).contiguous()
                          .transpose(2, 3), wp)


# ---------------------------------------------------------------------------
# the two gradient traps of the mixer
# ---------------------------------------------------------------------------

def test_softplus_gradient_matches_jax():
    """``jax.nn.softplus``' gradient (0.5 at 0, where autograd through
    the formula gives 1), with the forward unchanged."""
    xs = np.array([0.0, 1e-3, -1e-3, -2.0, 3.0], np.float32)
    want = jax.vmap(jax.grad(jax.nn.softplus))(jnp.asarray(xs))
    x = torch.tensor(xs, requires_grad=True)
    y = tb._softplus(x)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6)
    assert x.grad[0] == 0.5
    formula = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))
    assert torch.equal(y, formula)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jax.nn.softplus(xs)), rtol=1e-6)


def _chunk_li(q=256, dt=0.7):
    lcum = torch.cumsum(torch.full((1, 1, q, 2), -dt), dim=2)
    return lcum[:, :, :, None, :] - lcum[:, :, None, :, :]


def test_decay_qq_masked_first():
    """Masking before the exponential gives the old expression's values
    bit for bit; at a 256-long chunk with dt = 0.7 the old one's
    gradient is NaN (exp overflows above the diagonal, 0 * inf) and the
    new one's finite."""
    q = 256
    tri = torch.ones((q, q), dtype=torch.bool).tril()[:, :, None]
    grads = []
    for masked_first in (False, True):
        li = _chunk_li(q).requires_grad_()
        assert li.max() > 170
        out = torch.exp(torch.where(tri, li, -math.inf)) if masked_first \
            else torch.where(tri, torch.exp(li), 0.0)
        out.sum().backward()
        grads.append((out.detach(), li.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.isnan(grads[0][1]).any()
    assert torch.isfinite(grads[1][1]).all()


def test_mamba2_train_gradients_finite_at_chunk_256():
    """One smoke layer at chunk 256 over 512 tokens, dt ~ 0.7 and a = -1
    (the full-width init's regime): the train-mode output equals the
    prefill's, both differentiated, and every parameter's gradient is
    finite."""
    cfg = dataclasses.replace(treg.get(ARCH), ssm_chunk=256)
    p = tlm._index(tlm.init_params(cfg, device="cpu")["blocks"]["l0"]
                   ["mixer"], 0)
    rng = np.random.default_rng(3)
    p["in_dt"]["w"] = torch.zeros_like(p["in_dt"]["w"])
    p["dt_bias"] = torch.full_like(p["dt_bias"], math.log(math.expm1(0.7)))
    leaves = {k: (v["w"] if isinstance(v, dict) else v) for k, v in p.items()}
    for t in leaves.values():
        t.requires_grad_()
    x = torch.as_tensor(rng.normal(size=(1, 512, cfg.d_model))
                        .astype(np.float32)).to(torch.bfloat16)
    getw = lambda pp: pp["w"].to(torch.bfloat16)  # noqa: E731
    y, st = tb.mamba2_layer(p, x, cfg, mode="train", effective_w=getw)
    # both differentiated: B and C are rounded as where XLA saves them
    y_pre, _ = tb.mamba2_layer(p, x, cfg, mode="prefill", effective_w=getw)
    assert st is None and torch.equal(y, y_pre)
    y.float().square().sum().backward()
    for k, t in leaves.items():
        assert t.grad is not None and torch.isfinite(t.grad).all(), k
    assert leaves["a_log"].grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# the LM under the search
# ---------------------------------------------------------------------------

def test_loss_cost_and_grads_match_jax(world):
    jcfg, tcfg, jp, tp = world
    jb, tb_ = _batch(jcfg, 0)
    jctx, tctx = jmps.SearchCtx(tau=1.0), tmps.SearchCtx(tau=1.0)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b, ctx=jctx, lam=LAM)))(jp, jb)
    before = tssd.ssd_scan.launches
    tl, tg = tgrad.value_and_grad(
        lambda p, b: tlm.loss_fn(tcfg, p, b, ctx=tctx, lam=LAM), tp, tb_)
    assert tssd.ssd_scan.launches == before      # the CPU launches nothing
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5)
    want_cost = jax.jit(lambda p: jlm.mps_size_cost(jcfg, p, jctx))(jp)
    with torch.no_grad():
        got_cost = tlm.mps_size_cost(tcfg, tp, tctx)
    np.testing.assert_allclose(float(got_cost), float(want_cost), rtol=1e-6)
    want, got = _flat(jg), _flat(tg)
    assert sorted(got) == sorted(want)
    assert {k.split("/")[-1] for k in got if "/mixer/" in k} >= {
        "conv_x", "conv_b", "conv_c", "dt_bias", "a_log", "d_skip",
        "ssm_norm", "gamma", "w"}
    for k, v in want.items():
        assert np.isfinite(got[k]).all(), k
        assert _rel(got[k], v) < 3e-2, (k, _rel(got[k], v))
        if k.endswith("gamma"):
            assert (np.abs(got[k]).sum(axis=(1, 2)) > 0).all(), k


def test_make_train_step_and_plan_match_jax(world):
    jcfg, tcfg, jp, tp = world
    lr = 3e-4
    jo, to = jopt.make_optimizer("adam", lr), topt.make_optimizer("adam", lr)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jo, search=True))
    tstep = tsteps.make_train_step(tcfg, to, search=True)
    js, ts = jo.init(jp), to.init(tp)
    start = _flat(jp)
    for step in range(3):
        jb, tb_ = _batch(jcfg, step, batch=4, seq=33)
        jp, js, jl = jstep(jp, js, jb, jnp.asarray(step))
        tp, ts, tl = tstep(tp, ts, tb_, step)
        np.testing.assert_allclose(float(tl), float(jl), rtol=2e-4)
        assert np.isfinite(float(tstep.grad_norm))
    want, got = _flat(jp), _flat(tp)
    for k, v in want.items():
        assert np.abs(got[k] - v).max() <= 6 * lr, k
        rel = _rel(got[k] - start[k], v - start[k])
        assert rel < 0.15, (k, rel)
    # the plan: the searched gammas are still at their near-uniform
    # init after three steps, so redraw them to hold the argmax
    rng = np.random.default_rng(4)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: rng.normal(size=x.shape).astype(np.float32)
        if path[-1].key == "gamma" else x, jp)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg=tcfg)
    jplan, tplan = jlm.extract_plan(jcfg, jp), tlm.extract_plan(tcfg, tp)
    assert tplan.groups == jplan.groups
    assert len(tplan.groups) == 6 * tlm.n_superblocks(tcfg)
    assert {g.split(".")[3] for g in tplan.groups} == set(tlm._MAMBA_PROJ)
    for grp in jplan.groups:
        np.testing.assert_array_equal(tplan.channel_bits[grp],
                                      jplan.channel_bits[grp])
        np.testing.assert_array_equal(tplan.permutations[grp],
                                      jplan.permutations[grp])
    assert tplan.meta == jplan.meta == {"track": "lm", "arch": ARCH}


def test_train_launcher_on_a_mamba_stack():
    """``launch.train --search`` on the smoke Mamba-2 stack trains, and
    prints the plan; a sequence its chunk does not tile raises."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", ARCH, "--search", "--steps", "2"]
    out = subprocess.run(cmd + ["--seq", "64"], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert sum(x.startswith("[train] step ") for x in lines) == 2
    assert any(x.startswith("[train] CompressionPlan") or "groups" in x
               for x in lines if x.startswith("[train] ")), out.stdout
    bad = subprocess.run(cmd + ["--seq", "40"], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert bad.returncode != 0 and "multiple" in bad.stderr, bad.stderr


def test_remat_recomputes_k5_and_gives_the_same_gradients(world, monkeypatch):
    """Under ``cfg.remat`` each super-block's forward, K5 included, runs
    twice a step (the checkpointed recompute) and its backward once, and
    the gradients equal those without remat bit for bit."""
    _, tcfg, _, tp = world
    jb, tb_ = _batch(treg.get(ARCH), 1)
    calls = {"fwd": 0, "bwd": 0}
    scan, bwd = tssd._scan, tssd.ssd_scan_bwd

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tssd, "_scan", count("fwd", scan))
    monkeypatch.setattr(tssd, "ssd_scan_bwd", count("bwd", bwd))
    ctx = tmps.SearchCtx(tau=1.0)
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        calls.update(fwd=0, bwd=0)
        _, grads[remat] = tgrad.value_and_grad(
            lambda p, b: tlm.loss_fn(cfg, p, b, ctx=ctx, lam=LAM), tp, tb_)
        n = tcfg.n_layers
        assert calls == {"fwd": n * (2 if remat else 1), "bwd": n}, remat
    a, b = _flat(grads[False]), _flat(grads[True])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
