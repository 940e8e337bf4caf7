"""The port's CUDA kernels held against their plain PyTorch versions on
the card.  Every test here needs a CUDA device (``-m gpu``); without one
the ``cuda`` fixture skips it.  Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This module imports only torch, numpy and the port, so it also holds
``make_case``, which builds the paged pools the CPU parity tests share.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro_torch.kernels.mps_combine import ops as mops
from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.kernels.quant_matmul import ops as qops
from repro_torch.kernels.quant_matmul import ref as qref
from repro_torch.kernels.ssd_scan import ops as sops

pytestmark = pytest.mark.gpu


def make_case(rng, lens, *, h=4, hkv=2, hd=16, ps=8, n_pb=4, n_pages=None,
              poison_null=False, poison_tail=None, s=None):
    """Numpy pool + block tables for slots holding ``lens`` tokens each
    (the JAX package's ``tests/test_paged_attention.make_case``).

    Physical pages come from a random permutation of the pool; a
    zero-length slot gets an all-null row (a freed slot);
    ``poison_tail`` fills every allocated position past a slot's length.
    Returns ``(q, k_pool, v_pool, tables, pos)``; q is (B, H, D), or
    (B, s, H, D) when ``s`` is given (prefill)."""
    b = len(lens)
    if n_pages is None:
        n_pages = b * n_pb
    pool_k = rng.normal(size=(n_pages + 1, ps, hkv, hd)).astype(np.float32)
    pool_v = rng.normal(size=(n_pages + 1, ps, hkv, hd)).astype(np.float32)
    if poison_null:
        pool_k[0] = np.nan
        pool_v[0] = np.nan
    tables = np.zeros((b, n_pb), np.int32)
    perm = rng.permutation(np.arange(1, n_pages + 1))
    idx = 0
    pos = np.zeros((b,), np.int32)
    for bi, n in enumerate(lens):
        npg = -(-n // ps)
        for p in range(npg):
            tables[bi, p] = perm[idx]
            idx += 1
        pos[bi] = max(n - 1, 0)
        if poison_tail is not None and npg:
            last = tables[bi, npg - 1]
            off = n - (npg - 1) * ps
            pool_k[last, off:] = poison_tail
            pool_v[last, off:] = poison_tail
    qshape = (b, h, hd) if s is None else (b, s, h, hd)
    q = rng.normal(size=qshape).astype(np.float32)
    return q, pool_k, pool_v, tables, pos


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, case, dtype=torch.float32):
    q, k, v, t, p = case
    return (torch.as_tensor(q, device=dev).to(dtype),
            torch.as_tensor(k, device=dev).to(dtype),
            torch.as_tensor(v, device=dev).to(dtype),
            torch.as_tensor(t, device=dev), torch.as_tensor(p, device=dev))


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("m,k,n", [(1, 100, 70), (13, 37, 130),
                                   (8, 2048, 512), (512, 8192, 2048),
                                   (1, 2048, 8192), (3, 8192, 2048)])
def test_quant_matmul_bitwise(cuda, bits, m, k, n):
    """K1 equals the int32-exact plain version bit for bit, on both its
    layouts (tiles; one warp per column for M <= 8) and ragged shapes
    (masked, not padded)."""
    g = torch.Generator(device="cuda").manual_seed(m * 7 + n)
    qmax = 2 ** (bits - 1) - 1
    per = 8 // bits
    kp = -(-k // per) * per
    xq = torch.randint(-127, 128, (m, k), generator=g, device=cuda,
                       dtype=torch.int8)
    wq = torch.randint(-qmax, qmax + 1, (n, kp), generator=g, device=cuda,
                       dtype=torch.int8)
    wq[:, k:] = 0
    sw = torch.rand(n, generator=g, device=cuda) * 0.01
    sx = torch.full((), 0.75, device=cuda)
    packed = qref.pack_weights(wq, bits)
    before = qops.quant_matmul.launches
    got = qops.quant_matmul(xq, packed, sw, sx, w_bits=bits)
    torch.cuda.synchronize()
    assert qops.quant_matmul.launches == before + 1
    want = qref.quant_matmul_ref(xq, wq[:, :k], sw, sx)
    assert torch.equal(got, want)


@pytest.mark.parametrize("hkv", [1, 2, 4])
@pytest.mark.parametrize("window,chunked,cap", [
    (0, False, 0.0), (6, False, 0.0), (8, True, 0.0), (0, False, 30.0)])
def test_paged_decode_vs_plain(cuda, hkv, window, chunked, cap):
    """K2 within 2e-5 of its plain version in f32, with a NaN null page,
    partial-page garbage and a freed slot; finite everywhere."""
    rng = np.random.default_rng(hkv)
    case = make_case(rng, (5, 17, 0, 31), hkv=hkv, poison_null=True,
                     poison_tail=7.0)
    args = _on(cuda, case)
    kw = dict(window=window, chunked=chunked, cap=cap)
    before = pops.paged_attention_fwd.launches
    got = pops.paged_attention_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert pops.paged_attention_fwd.launches == before + 1
    want = pops.paged_attention_ref(*args, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert torch.equal(got[2], torch.zeros_like(got[2]))   # freed slot


@pytest.mark.parametrize("window,chunked,cap", [
    (0, False, 0.0), (6, False, 0.0), (8, True, 0.0), (0, False, 30.0)])
def test_paged_prefill_vs_plain_and_chunk_invariant(cuda, window, chunked,
                                                    cap):
    """K3 within 2e-5 of its plain version in f32 on the real rows, and
    bitwise independent of the q-chunk width."""
    rng = np.random.default_rng(3)
    lens = (16, 32, 11)
    q, k, v, t, _ = make_case(rng, lens, poison_null=True, s=32)
    args = _on(cuda, (q, k, v, t, np.asarray(lens, np.int32)))
    kw = dict(window=window, chunked=chunked, cap=cap)
    outs = [pops.paged_prefill_fwd(*args, q_chunk=qc, **kw)
            for qc in (1, 2, 4, 8, 16)]
    torch.cuda.synchronize()
    want = pops.paged_prefill_ref(*args, q_chunk=16, **kw)
    for bi, n in enumerate(lens):      # rows past lens are garbage
        for o in outs[:-1]:
            assert torch.equal(o[bi, :n], outs[-1][bi, :n])
        torch.testing.assert_close(outs[-1][bi, :n], want[bi, :n],
                                   rtol=2e-5, atol=2e-5)


def test_bf16_pools(cuda):
    """bf16 pools: both kernels agree with their plain versions to within
    one bf16 rounding of the output (the f32 math is the same)."""
    rng = np.random.default_rng(5)
    case = make_case(rng, (9, 30), hkv=2, poison_null=True)
    args = _on(cuda, case, torch.bfloat16)
    got = pops.paged_attention_fwd(*args)
    want = pops.paged_attention_ref(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)
    q, k, v, t, _ = make_case(rng, (16, 24), s=32)
    args = _on(cuda, (q, k, v, t, np.asarray([16, 24], np.int32)),
               torch.bfloat16)
    got = pops.paged_prefill_fwd(*args)
    want = pops.paged_prefill_ref(*args)
    torch.testing.assert_close(got[0, :16].float(), want[0, :16].float(),
                               rtol=1e-2, atol=1e-2)


# the resnet18 search's weight shapes viewed as (C_out, C_in * kh * kw),
# plus a ragged row (K % 4 != 0), a misaligned view and a row too long
# for shared memory
K4_SHAPES = [(64, 27), (64, 576), (128, 576), (128, 1152), (128, 64),
             (256, 1152), (256, 2304), (256, 128), (512, 2304),
             (512, 4608), (512, 256), (200, 512), (5, 61), (3, 60000)]


@pytest.mark.parametrize("m,k", K4_SHAPES)
def test_mps_combine_bitwise_and_backward(cuda, m, k):
    """K4's forward equals its plain version bit for bit; its backward
    (closed form, plain torch) agrees with autograd through the plain
    version within rtol 1e-4 (the dprobs row sums run in another
    order)."""
    pw = (0, 2, 4, 8)
    g = torch.Generator(device="cuda").manual_seed(m * 13 + k)
    w = torch.randn(m, k, generator=g, device=cuda)
    w[0, :3] = 0.0
    probs = torch.softmax(torch.randn(m, 4, generator=g, device=cuda), -1)
    before = mops.mps_combine_fwd.launches
    got = mops.mps_combine_fwd(w, probs, pw)
    torch.cuda.synchronize()
    assert mops.mps_combine_fwd.launches == before + 1
    assert torch.equal(got, mops.mps_combine_ref(w, probs, pw))
    up = torch.randn(m, k, generator=g, device=cuda)
    wk, pk = w.clone().requires_grad_(), probs.clone().requires_grad_()
    (mops.mps_combine(wk, pk, pw) * up).sum().backward()
    wr, pr = w.clone().requires_grad_(), probs.clone().requires_grad_()
    (mops.mps_combine_ref(wr, pr, pw) * up).sum().backward()
    for a, b in ((wk.grad, wr.grad), (pk.grad, pr.grad)):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * b.abs().max().item())


def test_mps_combine_misaligned_view(cuda):
    """A view that starts off a 16-byte boundary takes the scalar path
    and stays bitwise."""
    g = torch.Generator(device="cuda").manual_seed(1)
    base = torch.randn(64 * 576 + 1, generator=g, device=cuda)
    w = base[1:].view(64, 576)
    probs = torch.softmax(torch.randn(64, 4, generator=g, device=cuda), -1)
    assert torch.equal(mops.mps_combine_fwd(w, probs, (0, 2, 4, 8)),
                       mops.mps_combine_ref(w, probs, (0, 2, 4, 8)))


def _ssd_case(dev, c, h, p, n, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    dec = torch.rand(c, h, generator=g) * 0.7 + 0.3
    s_in = torch.randn(c, h, p, n, generator=g)
    s0 = torch.randn(h, p, n, generator=g)
    return dec.to(dev), s_in.to(dev), s0.to(dev)


@pytest.mark.parametrize("c", [1, 2, 509])
@pytest.mark.parametrize("h,p,n", [(1, 64, 128), (3, 64, 128),
                                   (48, 64, 128), (3, 5, 7)])
def test_ssd_scan_bitwise(cuda, c, h, p, n):
    """K5 equals its plain version bit for bit at ragged head counts, one
    chunk and a prime chunk count; (3, 5, 7) has P * N odd and takes the
    one-float-a-thread path."""
    dec, s_in, s0 = _ssd_case(cuda, c, h, p, n, seed=c * 100 + h)
    before = sops.ssd_scan.launches
    prefix, final = sops.ssd_scan(dec, s_in, s0)
    torch.cuda.synchronize()
    assert sops.ssd_scan.launches == before + 1
    want_p, want_f = sops.ssd_scan_ref(dec, s_in, s0)
    assert torch.equal(prefix, want_p) and torch.equal(final, want_f)
    assert torch.equal(prefix[0], s0)


def test_ssd_scan_misaligned_view(cuda):
    """Views that start off a 16-byte boundary take the scalar path and
    stay bitwise."""
    dec, s_in, s0 = _ssd_case(cuda, 4, 3, 64, 128, seed=9)
    base = torch.zeros(s_in.numel() + 1, device=cuda)
    base[1:] = s_in.reshape(-1)
    s_in_v = base[1:].view(s_in.shape)
    got = sops.ssd_scan(dec, s_in_v, s0)
    want = sops.ssd_scan_ref(dec, s_in, s0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ssd_scan_dispatch_and_checks(cuda):
    """A CPU tensor takes the plain version without a launch; a wrong
    dtype, shape, layout or a device mix raises."""
    dec, s_in, s0 = _ssd_case("cpu", 3, 2, 4, 4, seed=1)
    before = sops.ssd_scan.launches
    got = sops.ssd_scan(dec, s_in, s0)
    assert sops.ssd_scan.launches == before
    want = sops.ssd_scan_ref(dec, s_in, s0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    dc, sc, s0c = dec.to(cuda), s_in.to(cuda), s0.to(cuda)
    with pytest.raises(TypeError):
        sops.ssd_scan(dc, sc.double(), s0c)
    with pytest.raises(ValueError):
        sops.ssd_scan(dc, sc[:, :1], s0c)
    with pytest.raises(ValueError):
        sops.ssd_scan(dc, sc.transpose(2, 3), s0c.transpose(1, 2))
    with pytest.raises(ValueError):
        sops.ssd_scan(dc, sc, s0)
    assert sops.ssd_scan.launches == before
