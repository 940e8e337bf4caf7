"""The port's plain paged-attention versions against the JAX package's
gathered views (``paged_attention_view`` / ``paged_prefill_view``) on the
CPU, on the JAX package's own cases: GQA groups, a NaN-poisoned null
page, partial-page garbage, a freed slot, physical page permutations and
the window / chunked / softcap variants.  The tolerance is the JAX
package's kernel-vs-view bound, 2e-5 in f32."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro.kernels.paged_attention import ops as jops
from repro_torch.kernels.paged_attention import ops as tops
from test_torch_gpu import make_case

VARIANTS = [(0, False, 0.0), (6, False, 0.0), (8, True, 0.0),
            (0, False, 30.0), (3, False, 50.0)]
TOL = dict(rtol=2e-5, atol=2e-5)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("hkv", [1, 2, 4])
@pytest.mark.parametrize("window,chunked,cap", VARIANTS)
def test_decode_matches_jax_view(hkv, window, chunked, cap):
    rng = np.random.default_rng(hkv)
    lens = (5, 17, 0, 31)
    case = make_case(rng, lens, hkv=hkv, poison_tail=3.0)
    kw = dict(window=window, chunked=chunked, cap=cap)
    want = np.asarray(jops.paged_attention_view(*_j(*case), **kw))
    live = [i for i, n in enumerate(lens) if n]    # view: freed undefined
    for fn in (tops.paged_attention_ref, tops.paged_attention_view):
        got = fn(*_t(*case), **kw).numpy()
        np.testing.assert_allclose(got[live], want[live], **TOL)
    # the kernel's plain version never reads a dead page: a NaN null page
    # leaves every slot finite and the freed slot exactly zero
    q, kp, vp, tb, pos = case
    kp, vp = kp.copy(), vp.copy()
    kp[0] = vp[0] = np.nan
    got = tops.paged_attention_fwd(*_t(q, kp, vp, tb, pos), **kw).numpy()
    assert np.isfinite(got).all() and not got[2].any()
    np.testing.assert_allclose(got[live], want[live], **TOL)


def test_decode_ignores_physical_layout():
    """Relabelling the physical pages changes nothing."""
    rng = np.random.default_rng(7)
    q, kp, vp, tb, pos = make_case(rng, (9, 25, 14))
    perm = np.concatenate([[0], rng.permutation(np.arange(1, kp.shape[0]))])
    inv = np.argsort(perm)
    moved = (q, kp[perm], vp[perm], inv[tb].astype(np.int32), pos)
    a = tops.paged_attention_ref(*_t(q, kp, vp, tb, pos))
    b = tops.paged_attention_ref(*_t(*moved))
    assert torch.equal(a, b)


@pytest.mark.parametrize("window,chunked,cap", VARIANTS)
def test_prefill_matches_jax_view(window, chunked, cap):
    rng = np.random.default_rng(11)
    lens = (16, 32, 11)
    q, kp, vp, tb, _ = make_case(rng, lens, s=32)
    ln = np.asarray(lens, np.int32)
    kw = dict(window=window, chunked=chunked, cap=cap)
    want = np.asarray(jops.paged_prefill_view(*_j(q, kp, vp, tb, ln), **kw))
    kp_nan, vp_nan = kp.copy(), vp.copy()
    kp_nan[0] = vp_nan[0] = np.nan
    outs = {"view": tops.paged_prefill_view(*_t(q, kp, vp, tb, ln), **kw)}
    for qc in (1, 2, 4, 8, 16):
        outs[qc] = tops.paged_prefill_fwd(*_t(q, kp_nan, vp_nan, tb, ln),
                                          q_chunk=qc, **kw)
    for bi, n in enumerate(lens):             # rows past lens are padding
        for key, got in outs.items():
            np.testing.assert_allclose(got[bi, :n].numpy(),
                                       want[bi, :n], **TOL)
            if key != "view":                 # q-chunk width: bitwise
                assert torch.equal(got[bi, :n], outs[16][bi, :n])


def test_dispatch_defaults_and_force_impl():
    assert tops.resolve_impl(None, "cpu") == "view"
    assert tops.resolve_impl(None, "cuda") == "kernel"
    with tops.force_impl("kernel"):
        assert tops.resolve_impl(None, "cpu") == "kernel"
    with tops.force_impl("view"):
        assert tops.resolve_impl(None, "cuda") == "view"
    with pytest.raises(ValueError):
        tops.resolve_impl("ref")
    assert [tops.prefill_q_chunk(s) for s in (8, 24, 48, 7)] == [8, 8, 16, 1]
