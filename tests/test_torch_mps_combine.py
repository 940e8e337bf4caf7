"""Kernel K4's autograd function (``repro_torch.kernels.mps_combine.ops``)
on the CPU, against the JAX package's ``mps_combine`` custom VJP (its
forward the Pallas kernel in interpret mode) under ``jax.jit``, as the
reference's search runs it; and the backward wrapper against its plain
version.  Inputs come from numpy with a seed.

Stated tolerances, and why:
* ``ops.mps_combine_bwd`` on CPU tensors is ``_vjp_bwd``: bit for bit.
* Against the JAX custom VJP, the forward and dW are bit for bit where
  one precision is nonzero.  With several, XLA's CPU backend contracts
  each ``acc + p * q`` of the precision sum into an FMA, which the port
  (and its kernel, held bitwise against the port on the card) rounds in
  two steps: they agree within rtol 1e-6 (measured: at most 2 ULPs; the
  terms share a sign, so nothing cancels).
* dprobs within rtol 1e-5: its row sums run in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro.core import mps as jmps
from repro.core import sampling as jsamp
from repro.kernels.mps_combine import ops as jops
from repro_torch.core import mps as tmps
from repro_torch.core import sampling as tsamp
from repro_torch.kernels.mps_combine import ops as tops
from torch_threads import _one_torch_thread  # noqa: F401

PWS = [(0, 2, 4, 8), (2, 4, 8), (8,), (0, 8, 0, 2), (2, 3, 4, 5, 6, 7, 8, 16)]
# K % 4 != 0 and M = 1 among them
SHAPES = [(1, 37), (7, 40), (5, 27)]


def _inputs(seed, m, k, pw):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(m, k)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(rng.normal(size=(m, len(pw))), -1),
                       np.float32)
    up = rng.normal(size=(m, k)).astype(np.float32)
    return w, probs, up


def _jax(w, probs, up, pw):
    """Forward, dW and dprobs of the reference's custom VJP."""
    out, grads = jax.jit(jax.value_and_grad(
        lambda w, p: jnp.sum(jops.mps_combine(w, p, pw) * up),
        argnums=(0, 1)))(w, probs)
    fwd = jax.jit(lambda w, p: jops.mps_combine(w, p, pw))(w, probs)
    return np.asarray(fwd), np.asarray(grads[0]), np.asarray(grads[1])


def _port(w, probs, up, pw):
    tw = torch.tensor(w, requires_grad=True)
    tp = torch.tensor(probs, requires_grad=True)
    out = tops.mps_combine(tw, tp, pw)
    (out * torch.tensor(up)).sum().backward()
    return out.detach().numpy(), tw.grad.numpy(), tp.grad.numpy()


def _assert_matches_jax(got, want, pw):
    (fwd, dw, dp), (jfwd, jdw, jdp) = got, want
    if sum(b != 0 for b in pw) == 1:        # no precision sum to contract
        np.testing.assert_array_equal(fwd, jfwd)
        np.testing.assert_array_equal(dw, jdw)
    else:
        np.testing.assert_allclose(fwd, jfwd, rtol=1e-6, atol=0)
        np.testing.assert_allclose(dw, jdw, rtol=1e-6, atol=0)
    np.testing.assert_allclose(dp, jdp, rtol=1e-5,
                               atol=1e-6 * max(np.abs(jdp).max(), 1.0))


@pytest.mark.parametrize("m,k", SHAPES)
@pytest.mark.parametrize("pw", PWS)
def test_autograd_matches_jax_custom_vjp(pw, m, k):
    w, probs, up = _inputs(m * 100 + k, m, k, pw)
    _assert_matches_jax(_port(w, probs, up, pw), _jax(w, probs, up, pw), pw)


@pytest.mark.parametrize("pw", PWS)
def test_bwd_on_cpu_is_the_plain_version(pw):
    """On CPU tensors ``mps_combine_bwd`` runs ``_vjp_bwd`` (bitwise) and
    launches nothing; ``mps_combine_fwd`` fills the absmax it is given."""
    w, probs, up = (torch.tensor(a) for a in _inputs(3, 6, 44, pw))
    absmax = torch.empty(6)
    before = (tops.mps_combine_fwd.launches, tops.mps_combine_bwd.launches)
    out = tops.mps_combine_fwd(w, probs, pw, absmax)
    assert torch.equal(out, tops.mps_combine_ref(w, probs, pw))
    assert torch.equal(absmax, torch.amax(w.abs(), 1))
    dw, dp = tops.mps_combine_bwd(w, probs, absmax, up, pw)
    want_dw, want_dp = tops._vjp_bwd(w, probs, pw, up)
    assert torch.equal(dw, want_dw) and torch.equal(dp, want_dp)
    assert (tops.mps_combine_fwd.launches,
            tops.mps_combine_bwd.launches) == before


def _special_rows(pw):
    """Row 0: exact ties W = (k + 0.5) s of the widest precision; row 1:
    several elements on +-absmax (|W / s| = qmax, the STE mask 0.5);
    row 2 all zero (the 1e-8 floor); the rest random."""
    rng = np.random.default_rng(7)
    w = rng.uniform(-1.0, 1.0, size=(4, 24)).astype(np.float32)
    bits = max(pw)
    qmax = np.float32(2 ** (bits - 1) - 1)
    a = np.float32(2.0)
    s = a * (np.float32(1) / qmax)
    w[0] = ((np.arange(24) % int(qmax)) + np.float32(0.5)) * s
    w[0, 0] = a
    w[1, :6] = [a, -a, a, -a, a, a]
    w[2] = 0.0
    return w, s, qmax


@pytest.mark.parametrize("pw", [(0, 2, 4, 8), (2, 3, 4, 5, 6, 7, 8, 16)])
def test_ties_clip_boundary_and_zero_row(pw):
    w, s, qmax = _special_rows(pw)
    ratio = w / s
    assert (ratio[0, 1:] == np.floor(ratio[0, 1:]) + 0.5).sum() >= 12
    assert (np.abs(ratio[1]) == qmax).sum() == 6
    rng = np.random.default_rng(8)
    probs = np.asarray(jax.nn.softmax(rng.normal(size=(4, len(pw))), -1),
                       np.float32)
    up = rng.normal(size=w.shape).astype(np.float32)
    got = _port(w, probs, up, pw)
    _assert_matches_jax(got, _jax(w, probs, up, pw), pw)
    fwd, _, dp = got
    np.testing.assert_array_equal(fwd[2], 0.0)      # zero row: Q_p(W) = 0
    np.testing.assert_array_equal(dp[2], 0.0)
    # one-hot on the widest precision: the STE mask is 0.5 on the bound
    top = np.eye(len(pw), dtype=np.float32)[[pw.index(max(pw))]]
    _, lone_dw, _ = _port(w[1:2], top, up[1:2], pw)
    np.testing.assert_array_equal(lone_dw[0, :6], 0.5 * up[1, :6])


def test_layerwise_probs_expanded_from_one_row():
    """Layer-wise MPS: one selection row broadcast over the channels; the
    gradient reaching it sums over them."""
    pw = (0, 2, 4, 8)
    rng = np.random.default_rng(9)
    w = rng.normal(size=(12, 20)).astype(np.float32)
    gamma = rng.normal(size=(1, len(pw))).astype(np.float32)
    up = rng.normal(size=w.shape).astype(np.float32)
    jctx = jmps.SearchCtx(jsamp.SOFTMAX, 0.5, use_kernel=True)
    want, (jgw, jgg) = jax.jit(jax.value_and_grad(
        lambda w, g: jnp.sum(jmps.effective_weight(w, g, pw, jctx) * up),
        argnums=(0, 1)))(w, gamma)
    tctx = tmps.SearchCtx(tsamp.SOFTMAX, 0.5, use_kernel=True)
    tw = torch.tensor(w, requires_grad=True)
    tg = torch.tensor(gamma, requires_grad=True)
    got = torch.sum(tmps.effective_weight(tw, tg, pw, tctx)
                    * torch.tensor(up))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jgg), rtol=1e-5,
                               atol=1e-6 * max(np.abs(jgg).max(), 1.0))
