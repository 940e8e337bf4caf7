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
from repro_torch.kernels.paged_attention import ref as tref
from test_torch_gpu import make_case
from torch_threads import _one_torch_thread  # noqa: F401

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


def split_merge(q, k_pool, v_pool, tables, pos, *, split: int,
                window: int = 0, chunked: bool = False, cap: float = 0.0):
    """K2's flash-decoding on the CPU: the slot's logical tokens cut into
    splits of ``split`` tokens, each computed alone from (m = -1e30,
    l = 0, acc = 0) -- a null token zero-filled and masked, a split with
    no attendable backed token left neutral -- then the merge
    M = max m_s, l = sum l_s e^(m_s - M), out = sum acc_s e^(m_s - M) /
    max(l, 1e-30)."""
    b, h, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    qf = q.float().reshape(b, hkv, h // hkv, d)
    width = tables.shape[1] * ps
    posn = pos.long()
    parts = []
    for t0 in range(0, max(width, 1), split):
        j = torch.arange(t0, min(t0 + split, width))
        phys = tables[:, j // ps].long()                       # (B, T)
        backed = phys != 0
        k = torch.where(backed[..., None, None],
                        k_pool[phys, (j % ps)[None]].float(), 0.0)
        v = torch.where(backed[..., None, None],
                        v_pool[phys, (j % ps)[None]].float(), 0.0)
        s = torch.einsum("bhgd,bthd->bhgt", qf, k) / np.sqrt(d)
        s = tref.attention.softcap(s, cap)
        ok = backed & tref.pair_mask(j[None], posn[:, None], window=window,
                                     chunked=chunked)          # (B, T)
        s = torch.where(ok[:, None, None], s, tref.NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        live = ok.any(-1)[:, None, None, None]
        parts.append((torch.where(live, m, tref.NEG_INF),
                      torch.where(live, p.sum(-1, keepdim=True), 0.0),
                      torch.where(live, torch.einsum("bhgt,bthd->bhgd", p, v),
                                  0.0)))
    big_m = torch.stack([m for m, _, _ in parts]).amax(0)
    l = sum(ls * torch.exp(m - big_m) for m, ls, _ in parts)
    acc = sum(a * torch.exp(m - big_m) for m, _, a in parts)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, h, d).to(q.dtype)


SPLIT_LENS = (5, 17, 0, 31, 12)      # slot 2 freed


@pytest.mark.parametrize("ps", [1, 8])
@pytest.mark.parametrize("pages_per_split", [1, 2, 3, "all"])
@pytest.mark.parametrize("window,chunked,cap", VARIANTS[:4])
def test_split_merge_matches_jax_view(ps, pages_per_split, window, chunked,
                                      cap):
    """The split-and-merge function K2 computes equals the JAX package's
    gathered view within 2e-5: splits of 1, 2, 3 pages or the whole
    table, whole splits dead below a sliding (6) or chunked (8) window,
    softcap 30, 1- and 8-token pages, a NaN null page, poisoned
    partial-page tails and a freed slot that gives exact zeros."""
    rng = np.random.default_rng(ps * 10 + window)
    n_pb = -(-max(SPLIT_LENS) // ps)
    case = make_case(rng, SPLIT_LENS, hkv=2, ps=ps, n_pb=n_pb,
                     poison_tail=3.0)
    kw = dict(window=window, chunked=chunked, cap=cap)
    want = np.asarray(jops.paged_attention_view(*_j(*case), **kw))
    q, kp, vp, tb, pos = case
    kp, vp = kp.copy(), vp.copy()
    kp[0] = vp[0] = np.nan
    pps = n_pb if pages_per_split == "all" else pages_per_split
    got = split_merge(*_t(q, kp, vp, tb, pos), split=pps * ps, **kw).numpy()
    live = [i for i, n in enumerate(SPLIT_LENS) if n]
    assert np.isfinite(got).all()
    assert not got[SPLIT_LENS.index(0)].any()          # exact zeros
    np.testing.assert_allclose(got[live], want[live], **TOL)


@pytest.mark.parametrize("split", [5, 13, 128])
@pytest.mark.parametrize("window,chunked,cap", VARIANTS)
def test_split_merge_token_spans(split, window, chunked, cap):
    """Splits of a token span that cuts pages (5, 13) or exceeds the
    table (128) give the kernel's plain version within 2e-5, a freed
    slot exactly zero."""
    rng = np.random.default_rng(split)
    case = _t(*make_case(rng, SPLIT_LENS, hkv=1, ps=8, n_pb=4,
                         poison_null=True, poison_tail=7.0))
    kw = dict(window=window, chunked=chunked, cap=cap)
    got = split_merge(*case, split=split, **kw)
    want = tops.paged_attention_ref(*case, **kw)
    assert torch.isfinite(got).all() and not got[2].any()
    torch.testing.assert_close(got, want, **TOL)
