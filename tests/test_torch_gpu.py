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
    layouts (tiles; the mma.sync decode layout for M <= 8) and ragged shapes
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


def _k1_cases(n=27, seed=14):
    """A fixed sample of M x K x N x bits for the tensor-core tiles: every
    M, K, N and width appears, unaligned rows (K = 37, 100) included."""
    ms = (1, 9, 16, 17, 64, 65, 129, 512, 2048)
    ks = (37, 100, 1536, 2048, 8192)
    ns = (9, 37, 128, 1236, 3072)
    rng = np.random.default_rng(seed)
    pm, pk, pn = (rng.permutation(n) for _ in range(3))
    return [(ms[pm[i] % len(ms)], ks[pk[i] % len(ks)], ns[pn[i] % len(ns)],
             (8, 4, 2)[i % 3]) for i in range(n)]


def _k1_operands(dev, m, k, n, bits, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qmax = 2 ** (bits - 1) - 1
    per = 8 // bits
    xq = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-qmax - 1, qmax + 1, (n, -(-k // per) * per),
                       generator=g, device=dev, dtype=torch.int8)
    wq[:, k:] = 0
    sw = torch.rand(n, generator=g, device=dev) * 0.01
    return xq, wq, sw, torch.full((), 0.75, device=dev)


@pytest.mark.parametrize("m,k,n,bits", _k1_cases())
def test_quant_matmul_tiles_bitwise(cuda, m, k, n, bits):
    """K1's tensor-core tiles equal the int32-exact plain version bit for
    bit at ragged M, N and K (zero-filled inside the kernel), for every
    width; M <= 8 with unaligned rows also takes the tiles."""
    xq, wq, sw, sx = _k1_operands(cuda, m, k, n, bits, seed=m * 31 + k + n)
    before = qops.quant_matmul.launches
    got = qops.quant_matmul(xq, qref.pack_weights(wq, bits), sw, sx,
                            w_bits=bits)
    torch.cuda.synchronize()
    assert qops.quant_matmul.launches == before + 1
    assert torch.equal(got, qref.quant_matmul_ref(xq, wq[:, :k], sw, sx))


def test_quant_matmul_split_k_repeated(cuda):
    """Grids under half a wave split K over several blocks whose partial
    sums the tile's last block adds; interleaved and repeated calls (one
    tile split 8 ways, four tiles 6 ways, an unsplit grid) stay bitwise,
    so every launch leaves the arrival counts at zero."""
    shapes = [(17, 8192, 37, 4), (512, 1536, 48, 2), (2048, 1536, 1236, 8),
              (65, 2048, 128, 8)]
    cases = [(_k1_operands(cuda, *shape, seed=i), shape)
             for i, shape in enumerate(shapes)]
    for _ in range(3):
        for (xq, wq, sw, sx), (m, k, n, bits) in cases:
            got = qops.quant_matmul(xq, qref.pack_weights(wq, bits), sw,
                                    sx, w_bits=bits)
            assert torch.equal(got, qref.quant_matmul_ref(xq, wq[:, :k],
                                                          sw, sx))


def test_quant_matmul_split_k_two_streams(cuda):
    """Split-K launches on two streams at once each use their own
    stream's scratch, so their partial sums and counts never mix."""
    shapes = [(17, 8192, 37, 4), (512, 1536, 48, 2)]
    cases = [(_k1_operands(cuda, *shape, seed=10 + i), shape)
             for i, shape in enumerate(shapes)]
    streams = [torch.cuda.Stream(cuda) for _ in shapes]
    torch.cuda.synchronize()
    outs = [[] for _ in shapes]
    for _ in range(4):
        for i, ((xq, wq, sw, sx), (m, k, n, bits)) in enumerate(cases):
            with torch.cuda.stream(streams[i]):
                outs[i].append(qops.quant_matmul(
                    xq, qref.pack_weights(wq, bits), sw, sx, w_bits=bits))
    torch.cuda.synchronize()
    for ((xq, wq, sw, sx), (m, k, n, bits)), got in zip(cases, outs):
        want = qref.quant_matmul_ref(xq, wq[:, :k], sw, sx)
        assert all(torch.equal(y, want) for y in got)


# the decode layout's (K, N): mamba2-780m's in_dt / in_b,c-like groups
# (9, 48, 1236 wide), in_z / in_x and out_proj; llama3.2-1b's k/v, ffn
# up and down; and a K past one staged X chunk (8192 values)
K1_DECODE = [(1536, 9), (1536, 48), (1536, 1236), (1536, 3072),
             (3072, 1536), (2048, 512), (2048, 8192), (8192, 2048),
             (12288, 40)]


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("k,n", K1_DECODE)
def test_quant_matmul_decode_bitwise(cuda, k, n, bits):
    """K1's decode layout (mma.sync, M <= 8) equals the int32-exact plain
    version bit for bit at every M from 1 to 8 and every width."""
    for m in range(1, 9):
        xq, wq, sw, sx = _k1_operands(cuda, m, k, n, bits, seed=m + k + n)
        before = qops.quant_matmul.launches
        got = qops.quant_matmul(xq, qref.pack_weights(wq, bits), sw, sx,
                                w_bits=bits)
        torch.cuda.synchronize()
        assert qops.quant_matmul.launches == before + 1
        assert torch.equal(got, qref.quant_matmul_ref(xq, wq, sw, sx)), \
            f"M={m}"


@pytest.mark.parametrize("x_off,w_off", [(16, 0), (0, 16), (4, 0), (3, 5),
                                         (0, 8)])
def test_quant_matmul_decode_views(cuda, x_off, w_off):
    """Decode-shaped views: 16-byte aligned ones take the decode layout,
    the rest the tiles; all stay bitwise."""
    m, k, n, bits = 8, 1536, 130, 4
    xq, wq, sw, sx = _k1_operands(cuda, m, k, n, bits, seed=x_off + w_off)
    packed = qref.pack_weights(wq, bits)
    xb = torch.zeros(m * k + x_off, dtype=torch.int8, device=cuda)
    xb[x_off:] = xq.reshape(-1)
    wb = torch.zeros(packed.numel() + w_off, dtype=torch.int8, device=cuda)
    wb[w_off:] = packed.reshape(-1)
    got = qops.quant_matmul(xb[x_off:].view(m, k),
                            wb[w_off:].view(packed.shape), sw, sx,
                            w_bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, qref.quant_matmul_ref(xq, wq, sw, sx))


def test_quant_matmul_decode_two_streams(cuda):
    """Decode launches on two streams at once (split K in shared memory,
    no global scratch) stay bitwise."""
    shapes = [(8, 2048, 512, 4), (5, 1536, 48, 2), (8, 2048, 8192, 8)]
    cases = [(_k1_operands(cuda, *shape, seed=20 + i), shape)
             for i, shape in enumerate(shapes)]
    streams = [torch.cuda.Stream(cuda) for _ in shapes]
    torch.cuda.synchronize()
    outs = [[] for _ in shapes]
    for _ in range(4):
        for i, ((xq, wq, sw, sx), (m, k, n, bits)) in enumerate(cases):
            with torch.cuda.stream(streams[i]):
                outs[i].append(qops.quant_matmul(
                    xq, qref.pack_weights(wq, bits), sw, sx, w_bits=bits))
    torch.cuda.synchronize()
    for ((xq, wq, sw, sx), _), got in zip(cases, outs):
        want = qref.quant_matmul_ref(xq, wq, sw, sx)
        assert all(torch.equal(y, want) for y in got)


@pytest.mark.parametrize("x_off,w_off", [(3, 5), (4, 8), (0, 4), (1, 0)])
def test_quant_matmul_misaligned_views(cuda, x_off, w_off):
    """Operands whose storage starts off a 16-byte boundary take the
    kernel's 4-byte or byte copies and stay bitwise."""
    m, k, n, bits = 65, 1536, 130, 4
    xq, wq, sw, sx = _k1_operands(cuda, m, k, n, bits, seed=x_off + w_off)
    packed = qref.pack_weights(wq, bits)
    xb = torch.zeros(m * k + x_off, dtype=torch.int8, device=cuda)
    xb[x_off:] = xq.reshape(-1)
    wb = torch.zeros(packed.numel() + w_off, dtype=torch.int8, device=cuda)
    wb[w_off:] = packed.reshape(-1)
    xv = xb[x_off:].view(m, k)
    wv = wb[w_off:].view(packed.shape)
    assert xv.is_contiguous() and wv.is_contiguous()
    got = qops.quant_matmul(xv, wv, sw, sx, w_bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, qref.quant_matmul_ref(xq, wq, sw, sx))


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


K2_DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16,
                                                            1e-2)}


@pytest.mark.parametrize("window,chunked,cap", [
    (0, False, 0.0), (6, False, 0.0), (8, True, 0.0), (0, False, 30.0)])
@pytest.mark.parametrize("ps,width", [(1, 128), (8, 128), (16, 64)])
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
@pytest.mark.parametrize("dtype", list(K2_DTYPES))
def test_paged_decode_splits_vs_plain(cuda, dtype, hd, ps, width, window,
                                      chunked, cap):
    """K2's split-and-merge within 2e-5 (f32) / 1e-2 (bf16) of its plain
    version: 64- and 128-page tables, slots of 127, 128, 129 and 1000
    tokens (as many as the table holds) straddling the split edges, 1-,
    8- and 16-token pages, every mask mode and head dim, a NaN null page,
    poisoned tails and a freed slot."""
    dt, tol = K2_DTYPES[dtype]
    lens = tuple(n for n in (127, 128, 129, 1000) if n <= width * ps)
    lens += (0, 5)
    rng = np.random.default_rng(hd + ps + window)
    case = make_case(rng, lens, h=8, hkv=2, hd=hd, ps=ps, n_pb=width,
                     poison_null=True, poison_tail=7.0)
    args = _on(cuda, case, dt)
    kw = dict(window=window, chunked=chunked, cap=cap)
    before = pops.paged_attention_fwd.launches
    got = pops.paged_attention_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert pops.paged_attention_fwd.launches == before + 1
    want = pops.paged_attention_ref(*args, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    freed = lens.index(0)
    assert torch.equal(got[freed], torch.zeros_like(got[freed]))


@pytest.mark.parametrize("dtype", list(K2_DTYPES))
def test_paged_decode_table_view_and_freed(cuda, dtype):
    """A view of the first P columns of wider tables (row stride > P)
    reads only those; a batch of freed slots gives exact zeros."""
    dt, tol = K2_DTYPES[dtype]
    rng = np.random.default_rng(21)
    lens = (40, 3, 64, 17)
    q, k, v, t, pos = _on(cuda, make_case(rng, lens, h=8, hkv=2, hd=64,
                                          ps=8, n_pb=16, poison_null=True),
                          dt)
    view = t[:, :8]                   # 64 tokens of a 128-token table
    assert view.stride(0) == 16
    got = pops.paged_attention_fwd(q, k, v, view, pos)
    want = pops.paged_attention_ref(q, k, v, view.contiguous(), pos)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    freed = pops.paged_attention_fwd(q, k, v, torch.zeros_like(t),
                                     torch.zeros_like(pos))
    torch.cuda.synchronize()
    assert torch.equal(freed, torch.zeros_like(freed))


def test_paged_decode_two_streams(cuda):
    """Launches on two streams at once (each call its own partials'
    scratch) agree with the plain version and with themselves."""
    rng = np.random.default_rng(24)
    cases = [_on(cuda, make_case(rng, lens, h=8, hkv=2, hd=64, ps=8,
                                 n_pb=32, poison_null=True), torch.bfloat16)
             for lens in ((200, 0, 31, 256), (17, 129, 255, 1))]
    wants = [pops.paged_attention_ref(*args) for args in cases]
    streams = [torch.cuda.Stream(cuda) for _ in cases]
    torch.cuda.synchronize()
    outs = [[] for _ in cases]
    for _ in range(4):
        for i, args in enumerate(cases):
            with torch.cuda.stream(streams[i]):
                outs[i].append(pops.paged_attention_fwd(*args))
    torch.cuda.synchronize()
    for want, got in zip(wants, outs):
        for y in got:
            torch.testing.assert_close(y.float(), want.float(), rtol=1e-2,
                                       atol=1e-2)
        assert all(torch.equal(y, got[0]) for y in got)


def test_paged_decode_main_shape(cuda):
    """llama3.2-1b's decode shape: 8 slots of 1 to 1000 tokens (one
    freed), 32 query heads over 8 KV heads of 64, 16-token pages, 64-page
    tables, f32 and bf16."""
    lens = (1, 17, 200, 512, 1000, 0, 777, 64)
    for dtype, (dt, tol) in K2_DTYPES.items():
        rng = np.random.default_rng(22)
        args = _on(cuda, make_case(rng, lens, h=32, hkv=8, hd=64, ps=16,
                                   n_pb=64, poison_null=True), dt)
        got = pops.paged_attention_fwd(*args)
        torch.cuda.synchronize()
        want = pops.paged_attention_ref(*args)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(got[5], torch.zeros_like(got[5]))


def test_paged_decode_checks(cuda):
    """A head dim the decode kernel is not built for, or q off a 16-byte
    boundary, raises before any launch."""
    rng = np.random.default_rng(23)
    args = _on(cuda, make_case(rng, (9, 4), hd=48))
    before = pops.paged_attention_fwd.launches
    with pytest.raises(ValueError, match="head dims"):
        pops.paged_attention_fwd(*args)
    q, k, v, t, pos = _on(cuda, make_case(rng, (9, 4), hd=16))
    base = torch.zeros(q.numel() + 1, device=cuda)
    base[1:] = q.reshape(-1)
    with pytest.raises(ValueError, match="16-byte"):
        pops.paged_attention_fwd(base[1:].view(q.shape), k, v, t, pos)
    assert pops.paged_attention_fwd.launches == before


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


K3_VARIANTS = [(0, False, 0.0), (6, False, 0.0), (8, True, 0.0),
               (0, False, 30.0)]


@pytest.mark.parametrize("window,chunked,cap", K3_VARIANTS)
@pytest.mark.parametrize("ps", [1, 8, 16])
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
def test_paged_prefill_bf16_vs_plain(cuda, hd, ps, window, chunked, cap):
    """K3's tensor-core path (bf16 pools) within rtol = atol = 1e-2 of its
    plain version (f32 math) on the real rows, with a NaN null page and
    tokens gathered through tables of 1-, 8- and 16-token pages."""
    rng = np.random.default_rng(hd + ps)
    lens, s = (48, 30, 7), 48
    q, k, v, t, _ = make_case(rng, lens, h=8, hkv=2, hd=hd, ps=ps,
                              n_pb=-(-s // ps), poison_null=True, s=s)
    args = _on(cuda, (q, k, v, t, np.asarray(lens, np.int32)),
               torch.bfloat16)
    kw = dict(window=window, chunked=chunked, cap=cap)
    before = pops.paged_prefill_fwd.launches
    got = pops.paged_prefill_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert pops.paged_prefill_fwd.launches == before + 1
    want = pops.paged_prefill_ref(*args, **kw)
    for bi, n in enumerate(lens):      # rows past lens are garbage
        assert torch.isfinite(got[bi, :n]).all()
        torch.testing.assert_close(got[bi, :n].float(), want[bi, :n].float(),
                                   rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("window,chunked,cap", K3_VARIANTS)
def test_paged_prefill_bf16_chunk_invariant(cuda, window, chunked, cap):
    """The bf16 path tiles queries itself: every q chunk gives the same
    bits, padded rows included."""
    rng = np.random.default_rng(11)
    q, k, v, t, _ = make_case(rng, (16, 32, 11), h=8, hkv=2, hd=64,
                              poison_null=True, s=32)
    args = _on(cuda, (q, k, v, t, np.asarray((16, 32, 11), np.int32)),
               torch.bfloat16)
    kw = dict(window=window, chunked=chunked, cap=cap)
    outs = [pops.paged_prefill_fwd(*args, q_chunk=qc, **kw)
            for qc in (1, 2, 4, 8, 16)]
    torch.cuda.synchronize()
    for o in outs[:-1]:
        assert torch.equal(o, outs[-1])


# the MoE archs' attention shapes: llama4-scout's 40 query heads over 8 KV
# heads (G = 5) and arctic's 56 over 8 (G = 7), head dim 128 -- the first
# groups that are not a power of two, so K2's last head chunk of a group
# is partial (ceil(G / HPB) chunks)
MOE_GROUPS = [(40, 8), (56, 8)]


@pytest.mark.parametrize("dtype", list(K2_DTYPES))
@pytest.mark.parametrize("h,hkv", MOE_GROUPS)
def test_paged_decode_moe_groups_vs_plain(cuda, dtype, h, hkv):
    """K2 at G = 5 and 7, D = 128, a chunked window of 64 with slots on
    both sides of a chunk boundary (63, 64, 65, 130, 200 tokens), a freed
    slot, a NaN null page and poisoned tails; within 2e-5 (f32) / 1e-2
    (bf16) of its plain version, the freed slot exactly zero."""
    dt, tol = K2_DTYPES[dtype]
    lens = (63, 64, 65, 130, 0, 200)
    rng = np.random.default_rng(h)
    case = make_case(rng, lens, h=h, hkv=hkv, hd=128, ps=16, n_pb=16,
                     poison_null=True, poison_tail=7.0)
    args = _on(cuda, case, dt)
    kw = dict(window=64, chunked=True)
    got = pops.paged_attention_fwd(*args, **kw)
    torch.cuda.synchronize()
    want = pops.paged_attention_ref(*args, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got[4], torch.zeros_like(got[4]))


@pytest.mark.parametrize("dtype", list(K2_DTYPES))
@pytest.mark.parametrize("h,hkv", MOE_GROUPS)
def test_paged_prefill_moe_groups_vs_plain(cuda, dtype, h, hkv):
    """K3 at G = 5 and 7, D = 128, a chunked window of 64, prompts of 160
    (crossing two chunk boundaries), 100 and 40 tokens padded to 160 rows:
    within 2e-5 (f32) / 1e-2 (bf16) of its plain version on every row,
    padded rows included (they attend causally, as the plain version's
    do), and finite."""
    dt, tol = K2_DTYPES[dtype]
    lens, s = (160, 100, 40), 160
    rng = np.random.default_rng(h + 1)
    q, k, v, t, _ = make_case(rng, lens, h=h, hkv=hkv, hd=128, ps=16,
                              n_pb=s // 16, poison_null=True, s=s)
    args = _on(cuda, (q, k, v, t, np.asarray(lens, np.int32)), dt)
    kw = dict(window=64, chunked=True)
    got = pops.paged_prefill_fwd(*args, **kw)
    torch.cuda.synchronize()
    want = pops.paged_prefill_ref(*args, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# qwen2-vl-72b: 64 query heads over 8 KV heads (G = 8), head dim 128, and
# its projections (K, N): wq / wo, wk / wv, w_gate / w_up, w_down (29568 =
# 231 x 128; a plan's precision groups split it raggedly, the tile tests
# above hold ragged N)
VLM_K1 = [(8192, 8192), (8192, 1024), (8192, 29568), (29568, 8192)]


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("k,n", VLM_K1)
@pytest.mark.parametrize("m", [8, 2048])
def test_quant_matmul_vlm_shapes_bitwise(cuda, m, k, n, bits):
    """K1 at qwen2-vl's full widths, the decode layout (M = 8) and the
    tiles (M = 2048): bitwise against the int32-exact plain version."""
    xq, wq, sw, sx = _k1_operands(cuda, m, k, n, bits, seed=m + k + n)
    got = qops.quant_matmul(xq, qref.pack_weights(wq, bits), sw, sx,
                            w_bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, qref.quant_matmul_ref(xq, wq, sw, sx))


@pytest.mark.parametrize("dtype", list(K2_DTYPES))
def test_paged_decode_vlm_group_vs_plain(cuda, dtype):
    """K2 at G = 8, D = 128, pages of 16, slots of 1 to 1040 tokens, a
    freed slot, a NaN null page and poisoned tails: within 2e-5 (f32) /
    1e-2 (bf16) of its plain version, the freed slot exactly zero."""
    dt, tol = K2_DTYPES[dtype]
    lens = (1040, 17, 1, 0, 600, 16)
    rng = np.random.default_rng(64)
    case = make_case(rng, lens, h=64, hkv=8, hd=128, ps=16, n_pb=66,
                     poison_null=True, poison_tail=7.0)
    args = _on(cuda, case, dt)
    got = pops.paged_attention_fwd(*args)
    torch.cuda.synchronize()
    want = pops.paged_attention_ref(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got[3], torch.zeros_like(got[3]))


@pytest.mark.parametrize("dtype", list(K2_DTYPES))
def test_paged_prefill_vlm_group_vs_plain(cuda, dtype):
    """K3 at G = 8, D = 128, prompts of 400, 257 and 33 tokens padded to
    400 rows: within 2e-5 (f32) / 1e-2 (bf16) of its plain version on
    every row, and finite."""
    dt, tol = K2_DTYPES[dtype]
    lens, s = (400, 257, 33), 400
    rng = np.random.default_rng(65)
    q, k, v, t, _ = make_case(rng, lens, h=64, hkv=8, hd=128, ps=16,
                              n_pb=s // 16, poison_null=True, s=s)
    args = _on(cuda, (q, k, v, t, np.asarray(lens, np.int32)), dt)
    got = pops.paged_prefill_fwd(*args)
    torch.cuda.synchronize()
    want = pops.paged_prefill_ref(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_moe_layer_card_vs_cpu(cuda):
    """``blocks.moe_layer`` on the card against the same call on the CPU
    (bf16 weights, 16 experts, top-1, a shared FFN, 2 x 24 tokens): the
    same experts and the same kept tokens a expert, and the output within
    3e-2 relative L2 (cuBLAS and the CPU round the bf16 products
    differently)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.nn import blocks
    cfg = dataclasses.replace(registry.get("llama4-scout-17b-a16e-smoke"),
                              d_model=256, n_experts=16, moe_d_ff=128,
                              d_ff=256, param_dtype="bfloat16")
    params = lm.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    p_cpu = lm._index(params["blocks"]["l0"]["ffn"], 0)
    p_dev = {k: {kk: vv.to(cuda) for kk, vv in v.items()}
             if k != "shared" else
             {n: {"w": w["w"].to(cuda)} for n, w in v.items()}
             for k, v in p_cpu.items()}
    x = torch.randn(2, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(4)).bfloat16()
    cap = 3                     # ceil(48 * 1 * 1.25 / 16)
    sel = [blocks.moe_route(xx.reshape(48, -1), p["router"]["w"], top_k=1,
                            capacity=cap)
           for xx, p in ((x, p_cpu), (x.to(cuda), p_dev))]
    for a, b in zip(sel[0][1::2], sel[1][1::2]):   # ids, kept tokens
        assert torch.equal(a, b.cpu())
    y_cpu = blocks.moe_layer(p_cpu, x, cfg)
    y_dev = blocks.moe_layer(p_dev, x.to(cuda), cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(y_dev).all()
    rel = float((y_dev.cpu().float() - y_cpu.float()).norm()
                / y_cpu.float().norm())
    assert rel <= 3e-2, rel


def test_paged_prefill_bf16_main_shape(cuda):
    """llama3.2-1b's prefill shape: one 512-token prompt, 32 query heads
    over 8 KV heads of 64, 16-token pages, bf16."""
    rng = np.random.default_rng(12)
    q, k, v, t, _ = make_case(rng, (512,), h=32, hkv=8, hd=64, ps=16,
                              n_pb=64, poison_null=True, s=512)
    args = _on(cuda, (q, k, v, t, np.asarray([512], np.int32)),
               torch.bfloat16)
    got = pops.paged_prefill_fwd(*args)
    torch.cuda.synchronize()
    want = pops.paged_prefill_ref(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


def test_paged_prefill_bf16_checks(cuda):
    """A head dim the tensor-core path is not built for, or a pool that
    starts off a 16-byte boundary, raises before any launch."""
    rng = np.random.default_rng(13)
    q, k, v, t, _ = make_case(rng, (16,), hd=48, s=16)
    args = _on(cuda, (q, k, v, t, np.asarray([16], np.int32)),
               torch.bfloat16)
    before = pops.paged_prefill_fwd.launches
    with pytest.raises(ValueError, match="head dims"):
        pops.paged_prefill_fwd(*args)
    q, k, v, t, _ = make_case(rng, (16,), hd=16, s=16)
    q, k, v, t, ln = _on(cuda, (q, k, v, t, np.asarray([16], np.int32)),
                         torch.bfloat16)
    base = torch.zeros(k.numel() + 1, dtype=torch.bfloat16, device=cuda)
    base[1:] = k.reshape(-1)
    with pytest.raises(ValueError, match="16-byte"):
        pops.paged_prefill_fwd(q, base[1:].view(k.shape), v, t, ln)
    assert pops.paged_prefill_fwd.launches == before


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


K4_PWS = [(0, 2, 4, 8), (2, 4, 8), (8,), (0, 8, 0, 2),
          (2, 3, 4, 5, 6, 7, 8, 16)]
# small rows of few elements; problems large enough for the ring kernel
# whose tiles hold 8, 4 and 2 rows, the last tile short; and one as large
# whose rows are too long for two stages
K4_RAGGED_TILES = [(1, 4), (9, 8), (13, 64), (3, 256), (7, 512),
                   (37501, 64), (9377, 256), (4689, 512), (40, 60000)]
# mamba2-780m's projections as K4 takes them (rows x K): in_z / in_x and
# out_proj ring-sized, in_b / in_c and in_dt on the simple kernels
K4_MAMBA = [(3072, 1536), (1536, 3072), (128, 1536), (48, 1536)]
# seamless-m4t-medium's projections that reach K4 (rows x K): the
# attention's 1024 x 1024, w_gate / w_up 4096 x 1024, w_down 1024 x 4096
K4_SEAMLESS = [(1024, 1024), (4096, 1024), (1024, 4096)]


def _k4_case(dev, m, k, pw, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(m, k, generator=g, device=dev)
    w[0, :3] = 0.0
    if m > 2:
        w[2] = 0.0                                # an all-zero row
    probs = torch.softmax(torch.randn(m, len(pw), generator=g, device=dev),
                          -1)
    up = torch.randn(m, k, generator=g, device=dev)
    return w, probs, up


def _k4_check_bwd(w, probs, up, pw, dw, dprobs, absmax=None):
    """dW bit for bit against the plain version on the card; dprobs
    within the summation bound 2 K 2^-24 sum_k |g q| of a float64 row
    sum of the plain version's products g * Q_p(W) (scales from
    ``absmax`` when given)."""
    want_dw, _ = mops._vjp_bwd(w, probs, pw, up, absmax)
    assert torch.equal(dw, want_dw)
    k = w.shape[1]
    for p in range(len(pw)):
        onehot = torch.zeros_like(probs)
        onehot[:, p] = 1.0
        q = mops.mps_combine_ref(w, onehot, pw, absmax)   # Q_p(W)
        prod = (up * q).double()
        exact = prod.sum(1)
        bound = 2 * k * 2.0 ** -24 * prod.abs().sum(1)
        err = (dprobs[:, p].double() - exact).abs()
        assert bool((err <= bound).all()), (p, float((err - bound).max()))


@pytest.mark.parametrize("m,k", K4_SHAPES + K4_RAGGED_TILES + K4_MAMBA
                         + K4_SEAMLESS)
@pytest.mark.parametrize("pw", K4_PWS)
def test_mps_combine_kernels_precision_sets(cuda, pw, m, k):
    """The forward bit for bit and its absmax exactly; the backward
    kernel's dW bit for bit against ``_vjp_bwd`` on the card and its
    dprobs within the summation bound; one launch each."""
    w, probs, up = _k4_case(cuda, m, k, pw, m * 31 + k + len(pw))
    absmax = torch.empty(m, device=cuda)
    before = (mops.mps_combine_fwd.launches, mops.mps_combine_bwd.launches)
    got = mops.mps_combine_fwd(w, probs, pw, absmax)
    dw, dprobs = mops.mps_combine_bwd(w, probs, absmax, up, pw)
    torch.cuda.synchronize()
    assert (mops.mps_combine_fwd.launches,
            mops.mps_combine_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, mops.mps_combine_ref(w, probs, pw))
    assert torch.equal(absmax, torch.amax(w.abs(), 1))
    _k4_check_bwd(w, probs, up, pw, dw, dprobs)


# path 13's bank shards (4 of arctic's experts as C_out rows of E_loc *
# K: w_gate / w_up, w_down), beside ring- and simple-sized problems
K4_GIVEN = [(4864, 28672), (7168, 19456)]


def _given_absmax(w, seed):
    """Each row's absmax as an expert bank split over ranks gives it:
    at least the row's own max |w|, over some rows (the other ranks'
    rows held larger values), exactly it on the rest."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    up = torch.where(torch.rand(w.shape[0], generator=g, device=w.device)
                     < 0.5, 1.0, 1.3)
    return torch.amax(w.abs(), 1) * up


@pytest.mark.parametrize("m,k", K4_SHAPES + K4_RAGGED_TILES + K4_GIVEN)
@pytest.mark.parametrize("pw", [(0, 2, 4, 8), (2, 3, 4, 5, 6, 7, 8, 16)])
def test_mps_combine_given_absmax(cuda, pw, m, k):
    """K4's forward given each row's absmax (the TPU kernel's interface;
    ring and simple kernels) equals the plain version given the same
    absmax bit for bit; the backward's dW bit for bit and dprobs within
    the summation bound; the autograd function too; one launch, counted
    as given."""
    w, probs, up = _k4_case(cuda, m, k, pw, m * 7 + k + len(pw))
    absmax = _given_absmax(w, m + k)
    before = (mops.mps_combine_fwd.launches,
              mops.mps_combine_fwd.given_launches)
    got = mops.mps_combine_fwd(w, probs, pw, absmax_in=absmax)
    dw, dprobs = mops.mps_combine_bwd(w, probs, absmax, up, pw)
    torch.cuda.synchronize()
    assert (mops.mps_combine_fwd.launches,
            mops.mps_combine_fwd.given_launches) == (before[0] + 1,
                                                     before[1] + 1)
    assert torch.equal(got, mops.mps_combine_ref(w, probs, pw, absmax))
    _k4_check_bwd(w, probs, up, pw, dw, dprobs, absmax)
    wk = w.clone().requires_grad_()
    (mops.mps_combine(wk, probs, pw, absmax) * up).sum().backward()
    assert torch.equal(wk.grad, dw)


def test_mps_combine_given_absmax_misaligned_and_refused(cuda):
    """A view off a 16-byte boundary takes the simple kernel, bitwise;
    a wrong shape or dtype, an absmax on the CPU, or both absmax and
    absmax_in raise, and nothing launches."""
    pw = (0, 2, 4, 8)
    w0, probs, _ = _k4_case(cuda, 64, 576, pw, 3)
    base = torch.empty(w0.numel() + 1, device=cuda)
    base[1:] = w0.reshape(-1)
    w = base[1:].view(w0.shape)
    absmax = _given_absmax(w, 3)
    assert torch.equal(mops.mps_combine_fwd(w, probs, pw, absmax_in=absmax),
                       mops.mps_combine_ref(w, probs, pw, absmax))
    before = mops.mps_combine_fwd.launches
    for bad, err in ((absmax[:10], ValueError), (absmax.double(), TypeError),
                     (absmax.cpu(), ValueError)):
        with pytest.raises(err):
            mops.mps_combine_fwd(w, probs, pw, absmax_in=bad)
    with pytest.raises(ValueError, match="not both"):
        mops.mps_combine_fwd(w, probs, pw, torch.empty_like(absmax),
                             absmax_in=absmax)
    assert mops.mps_combine_fwd.launches == before


@pytest.mark.parametrize("pw", K4_PWS)
def test_mps_combine_misaligned_views_both_kernels(cuda, pw):
    """Views off a 16-byte boundary take the simple kernels, bitwise."""
    w0, probs, up0 = _k4_case(cuda, 64, 576, pw, 5)
    views = []
    for t in (w0, up0):
        base = torch.empty(t.numel() + 1, device=cuda)
        base[1:] = t.reshape(-1)
        views.append(base[1:].view(t.shape))
    w, up = views
    absmax = torch.empty(64, device=cuda)
    assert torch.equal(mops.mps_combine_fwd(w, probs, pw, absmax),
                       mops.mps_combine_ref(w, probs, pw))
    assert torch.equal(absmax, torch.amax(w.abs(), 1))
    dw, dprobs = mops.mps_combine_bwd(w, probs, absmax, up, pw)
    torch.cuda.synchronize()
    _k4_check_bwd(w, probs, up, pw, dw, dprobs)


@pytest.mark.parametrize("m", [16, 4700])
@pytest.mark.parametrize("pw", [(0, 2, 4, 8), (2, 3, 4, 5, 6, 7, 8, 16)])
def test_mps_combine_ties_clip_boundary_zero_row(cuda, pw, m):
    """Exact ties W = (k + 0.5) s, several elements on +-absmax (the STE
    mask 0.5) and an all-zero row (the 1e-8 floor), on the card: 16 rows
    take the simple kernels, 4700 the ring kernel."""
    k = 512
    g = torch.Generator(device="cuda").manual_seed(2)
    w = torch.rand(m, k, generator=g, device=cuda) * 2 - 1
    qmax = float(2 ** (max(pw) - 1) - 1)
    a = 2.0
    s = torch.tensor(a) * (torch.tensor(1.0) / torch.tensor(qmax))
    ties = ((torch.arange(k) % int(qmax)).float() + 0.5) * s
    w[0] = ties.to(cuda)
    w[0, 0] = a
    w[1, :40:3] = a
    w[1, 1:40:3] = -a
    w[2] = 0.0
    ratio = w / s.to(cuda)
    assert int((ratio[0, 1:] == ratio[0, 1:].floor() + 0.5).sum()) >= k // 2
    assert int((ratio[1].abs() == qmax).sum()) >= 20
    probs = torch.softmax(torch.randn(m, len(pw), generator=g, device=cuda),
                          -1)
    up = torch.randn(m, k, generator=g, device=cuda)
    absmax = torch.empty(m, device=cuda)
    out = mops.mps_combine_fwd(w, probs, pw, absmax)
    dw, dprobs = mops.mps_combine_bwd(w, probs, absmax, up, pw)
    torch.cuda.synchronize()
    assert torch.equal(out, mops.mps_combine_ref(w, probs, pw))
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    _k4_check_bwd(w, probs, up, pw, dw, dprobs)
    assert torch.equal(dprobs[2], torch.zeros_like(dprobs[2]))


def test_mps_combine_two_streams(cuda):
    """Each launch runs on the caller's current stream: two streams at
    once give each its own bitwise results."""
    pw = (0, 2, 4, 8)
    cases = [_k4_case(cuda, 512, 4608, pw, 10 + i) for i in range(2)]
    streams = [torch.cuda.Stream() for _ in cases]
    torch.cuda.synchronize()
    outs = []
    for (w, probs, up), st in zip(cases, streams):
        with torch.cuda.stream(st):
            absmax = torch.empty(512, device=cuda)
            out = mops.mps_combine_fwd(w, probs, pw, absmax)
            outs.append((out, absmax, *mops.mps_combine_bwd(w, probs, absmax,
                                                            up, pw)))
    torch.cuda.synchronize()
    for (w, probs, up), (out, absmax, dw, dprobs) in zip(cases, outs):
        assert torch.equal(out, mops.mps_combine_ref(w, probs, pw))
        assert torch.equal(absmax, torch.amax(w.abs(), 1))
        _k4_check_bwd(w, probs, up, pw, dw, dprobs)


def test_mps_combine_routes_by_size(cuda):
    """The ring kernel (bulk copies into a shared-memory ring) takes an
    aligned problem of at least 16384 elements an SM forward, 4096
    backward; the simple kernels take smaller ones, ragged rows and rows
    too long for two stages.  Read from the profiler's kernel names."""
    from torch.profiler import ProfilerActivity, profile
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    pw = (0, 2, 4, 8)

    def taken(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if "mps_" in e.key}
        assert len(names) == 1, names
        return "ring" if "mps_ring_kernel" in names.pop() else "simple"

    for m, k in K4_SHAPES + K4_RAGGED_TILES:
        w, probs, up = _k4_case(cuda, m, k, pw, 3)
        absmax = torch.empty(m, device=cuda)
        fits = k % 4 == 0 and k != 60000
        assert taken(lambda: mops.mps_combine_fwd(w, probs, pw, absmax)) == (
            "ring" if fits and m * k >= 16384 * sms else "simple"), (m, k)
        assert taken(lambda: mops.mps_combine_bwd(w, probs, absmax, up,
                                                  pw)) == (
            "ring" if fits and m * k >= 4096 * sms else "simple"), (m, k)


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


# jamba-1.5-large-398b: Mamba-2 with 128 heads of 128 and state 128 at
# batch 1 (C from 1 to 257: a prime prompt length's chunk is 1), and its
# planned projections (K, N): in_z / in_x, out_proj, in_b / in_c / in_dt,
# the dense FFN's gate / up and down
JAMBA_K1 = [(8192, 16384), (16384, 8192), (8192, 128), (8192, 24576),
            (24576, 8192)]


@pytest.mark.parametrize("c", [1, 20, 257])
def test_ssd_scan_jamba_shape_bitwise(cuda, c):
    """K5 at jamba's (C, 128, 128, 128): bitwise against its plain
    version."""
    dec, s_in, s0 = _ssd_case(cuda, c, 128, 128, 128, seed=c)
    prefix, final = sops.ssd_scan(dec, s_in, s0)
    torch.cuda.synchronize()
    want_p, want_f = sops.ssd_scan_ref(dec, s_in, s0)
    assert torch.equal(prefix, want_p) and torch.equal(final, want_f)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("k,n", JAMBA_K1)
@pytest.mark.parametrize("m", [1, 8, 257, 4100])
def test_quant_matmul_jamba_shapes_bitwise(cuda, m, k, n, bits):
    """K1 at jamba's five projection shapes, the decode layout (M = 1, 8)
    and the tiles at unpadded prompt lengths (M = 257, 4100): bitwise
    against the int32-exact plain version."""
    xq, wq, sw, sx = _k1_operands(cuda, m, k, n, bits, seed=m + k + n)
    got = qops.quant_matmul(xq, qref.pack_weights(wq, bits), sw, sx,
                            w_bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, qref.quant_matmul_ref(xq, wq, sw, sx))


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


def _ssd_bwd_case(dev, c, h, p, n, seed, with_final=True):
    g = torch.Generator(device="cpu").manual_seed(seed)
    dec, s_in, s0 = _ssd_case("cpu", c, h, p, n, seed)
    prefix, _ = sops.ssd_scan_ref(dec, s_in, s0)
    dprefix = torch.randn(c, h, p, n, generator=g)
    dfinal = torch.randn(h, p, n, generator=g) if with_final else None
    return tuple(None if t is None else t.to(dev)
                 for t in (dec, prefix, dprefix, dfinal))


def _ssd_bwd_check(got, dec, prefix, dprefix, dfinal):
    """ds_in and ds0 bitwise; ddecay within 2 * P * N * 2^-24 * sum |G *
    prefix| a (chunk, head): both sum the same rounded products, in a
    fixed tree on the card and in torch's order here."""
    want = sops.ssd_scan_bwd_ref(dec, prefix, dprefix, dfinal)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    pn = prefix.shape[2] * prefix.shape[3]
    lim = 2 * pn * 2.0 ** -24 * (want[1] * prefix).abs().sum(dim=(2, 3))
    assert bool(((got[0] - want[0]).abs() <= lim).all())


SSD_BWD_CASES = [(c, h, p, n) for c in (1, 2, 8)
                 for h, p, n in ((1, 64, 128), (48, 64, 128), (192, 64, 128),
                                 (3, 5, 7), (2, 3, 1000), (2, 3, 999))] + [
    (509, 1, 64, 128), (509, 48, 64, 128)]


@pytest.mark.parametrize("c,h,p,n", SSD_BWD_CASES)
@pytest.mark.parametrize("with_final", [True, False])
def test_ssd_scan_bwd_vs_plain(cuda, c, h, p, n, with_final):
    """K5's backward kernel against ``ssd_scan_bwd_ref`` at one head, the
    serving shape (48 heads), path 7's training shape (B * H = 192), P *
    N odd (the one-float path), heads of 3000 and 2997 elements whose
    last block is ragged (float4 and one-float paths) and 509 chunks;
    run twice, every output bit for bit the same."""
    args = _ssd_bwd_case(cuda, c, h, p, n, seed=c + h + p, with_final=
                         with_final)
    before = sops.ssd_scan_bwd.launches
    got = sops.ssd_scan_bwd(*args)
    again = sops.ssd_scan_bwd(*args)
    torch.cuda.synchronize()
    assert sops.ssd_scan_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _ssd_bwd_check(got, *args)


def test_ssd_scan_bwd_misaligned_view(cuda):
    """A dprefix off a 16-byte boundary takes the one-float path and
    stays within the check."""
    dec, prefix, dprefix, dfinal = _ssd_bwd_case(cuda, 4, 3, 64, 128, 11)
    base = torch.zeros(dprefix.numel() + 1, device=cuda)
    base[1:] = dprefix.reshape(-1)
    got = sops.ssd_scan_bwd(dec, prefix, base[1:].view(dprefix.shape),
                            dfinal)
    _ssd_bwd_check(got, dec, prefix, dprefix, dfinal)


def test_ssd_scan_autograd_on_the_card(cuda):
    """The autograd function launches the forward once and the backward
    once, and its gradients equal those of the plain reverse recurrence
    (the CPU path) bit for bit where the sums agree: ds_in and ds0."""
    dec, s_in, s0 = _ssd_case(cuda, 8, 48, 64, 128, seed=3)
    w = torch.randn(8, 48, 64, 128, device=cuda)
    args = [t.clone().requires_grad_() for t in (dec, s_in, s0)]
    f0, b0 = sops.ssd_scan.launches, sops.ssd_scan_bwd.launches
    prefix, final = sops.ssd_scan(*args)
    ((prefix * w).sum() + final.sum()).backward()
    torch.cuda.synchronize()
    assert (sops.ssd_scan.launches - f0, sops.ssd_scan_bwd.launches - b0) \
        == (1, 1)
    want = sops.ssd_scan_bwd_ref(dec, prefix.detach(), w,
                                 torch.ones_like(s0))
    assert torch.equal(args[1].grad, want[1])
    assert torch.equal(args[2].grad, want[2])
    torch.testing.assert_close(args[0].grad, want[0], rtol=1e-5, atol=1e-3)


def test_mamba2_train_layer_card_vs_cpu(cuda):
    """One ``mamba2-780m-smoke`` layer in train mode under the search at
    chunk 32 over 128 tokens (4 chunks): every parameter's gradient on
    the card (K4, K5 and its backward) within 1e-2 relative L2 of the
    CPU's (the plain versions; bf16 products round differently under
    cuBLAS)."""
    from repro_torch.configs import registry
    from repro_torch.core import mps
    from repro_torch.models import lm
    from repro_torch.nn import blocks
    cfg = registry.get("mamba2-780m-smoke")
    tree = lm._index(lm.init_params(cfg, device="cpu", mps_on=True)
                     ["blocks"]["l0"]["mixer"], 0)
    g = torch.Generator(device="cpu").manual_seed(4)
    x = torch.randn(2, 128, cfg.d_model, generator=g).to(torch.bfloat16)
    up = torch.randn(2, 128, cfg.d_model, generator=g)
    getw = lm._make_getw(cfg, mps.SearchCtx(tau=1.0))
    flat = {(k, kk): t for k, v in tree.items()
            for kk, t in (v.items() if isinstance(v, dict) else [(None, v)])}
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = {key: t.to(dev).clone().requires_grad_()
                  for key, t in flat.items()}
        p = {}
        for (k, kk), t in leaves.items():
            if kk is None:
                p[k] = t
            else:
                p.setdefault(k, {})[kk] = t
        sops.ssd_scan_bwd.launches = 0
        y, st = blocks.mamba2_layer(p, x.to(dev), cfg, mode="train",
                                    effective_w=getw)
        (y.float() * up.to(dev)).sum().backward()
        assert st is None
        assert sops.ssd_scan_bwd.launches == (dev == "cuda")
        grads[dev] = {key: t.grad.cpu().double()
                      for key, t in leaves.items()}
    for key, want in grads["cpu"].items():
        got = grads["cuda"][key]
        assert torch.isfinite(got).all(), key
        assert float((got - want).norm() / want.norm()) <= 1e-2, key


# ---------------------------------------------------------------------------
# K4 on the LM's channel-last weights, and one LM search step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n", [(64, 16), (64, 128), (128, 64),
                                 (2048, 512), (512, 2048)]
                         + [(k, m) for m, k in K4_MAMBA + K4_SEAMLESS])
def test_mps_combine_channel_last_route(cuda, k, n):
    """``core.mps.effective_weight`` on a (K, C_out) weight -- the LM's
    layout -- runs K4 on its rows under the default context: the
    effective weight and dW bit for bit against the plain versions on
    the transposed rows, dprobs within the summation bound, one launch of
    each kernel."""
    from repro_torch.core import mps
    pw = (0, 2, 4, 8)
    w, probs, up = _k4_case(cuda, n, k, pw, seed=n + k)
    w_kn = w.T.contiguous().requires_grad_()
    p = probs.clone().requires_grad_()
    mops.mps_combine_fwd.launches = mops.mps_combine_bwd.launches = 0
    out = mps.kernel_combine(w_kn, p, pw, channel_axis=1)
    out.backward(up.T.contiguous())
    torch.cuda.synchronize()
    assert (mops.mps_combine_fwd.launches,
            mops.mps_combine_bwd.launches) == (1, 1)
    assert out.shape == (k, n)
    assert torch.equal(out.detach().T, mops.mps_combine_ref(w, probs, pw))
    _k4_check_bwd(w, probs, up, pw, w_kn.grad.T, p.grad)
    # the same through effective_weight (softmax of gamma): K4, never the
    # plain stack
    gamma = torch.randn(n, len(pw), device=cuda)
    eff = mps.effective_weight(w_kn.detach(), gamma, pw, mps.SearchCtx(),
                               channel_axis=1)
    assert torch.equal(eff.T, mops.mps_combine_ref(
        w, torch.softmax(gamma, -1), pw))
    with pytest.raises(ValueError, match="CPU weights only"):
        mps.effective_weight(w_kn.detach(), gamma, pw,
                             mps.SearchCtx(use_kernel=False), channel_axis=1)


@pytest.mark.parametrize("e,k,n", [(4, 64, 128), (3, 200, 96),
                                   (8, 512, 384), (2, 64, 2052)])
def test_mps_combine_on_an_expert_bank(cuda, e, k, n):
    """``core.mps.kernel_combine`` on a 3-D expert bank ``(E, K, C_out)``
    with ``channel_axis=2`` (an MoE layer's ``w_gate`` / ``w_up`` /
    ``w_down`` against its one gamma): the bank's C_out rows of ``E * K``
    go through K4, the effective bank and dW bit for bit against the
    plain versions on those rows, dprobs within the summation bound, one
    launch each way; each channel's scale is taken over all of E and K
    (``quantize_weights_multi`` on the bank agrees)."""
    from repro_torch.core import mps, quantizers
    pw = (0, 2, 4, 8)
    rows, probs, up = _k4_case(cuda, n, e * k, pw, seed=e * k + n)
    bank = rows.reshape(n, e, k).permute(1, 2, 0).contiguous()
    bank.requires_grad_()
    p = probs.clone().requires_grad_()
    mops.mps_combine_fwd.launches = mops.mps_combine_bwd.launches = 0
    out = mps.kernel_combine(bank, p, pw, channel_axis=2)
    assert out.shape == (e, k, n)
    out.backward(up.reshape(n, e, k).permute(1, 2, 0).contiguous())
    torch.cuda.synchronize()
    assert (mops.mps_combine_fwd.launches,
            mops.mps_combine_bwd.launches) == (1, 1)
    flat = out.detach().permute(2, 0, 1).reshape(n, e * k)
    assert torch.equal(flat, mops.mps_combine_ref(rows, probs, pw))
    _k4_check_bwd(rows, probs, up, pw,
                  bank.grad.permute(2, 0, 1).reshape(n, e * k), p.grad)
    qs = quantizers.quantize_weights_multi(bank.detach(), pw, 2)
    want = torch.sum(torch.movedim(probs, -1, 0)[:, None, None, :] * qs, 0)
    torch.testing.assert_close(out.detach(), want, rtol=1e-5, atol=1e-6)


def test_lm_search_step_on_the_card(cuda):
    """One search step of ``llama3.2-1b-smoke`` (remat on) on the card:
    finite loss and gradient norm, every projection's K4 forward launched
    twice (the recompute) and its backward once."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import optimizers
    cfg = dataclasses.replace(registry.get("llama3.2-1b-smoke"), remat=True)
    params = lm.init_params(cfg, device=cuda, mps_on=True)
    opt = optimizers.make_optimizer("adam", 3e-4)
    step = steps.make_train_step(cfg, opt, search=True)
    batch = synthetic.lm_batch(cfg.vocab, 65, 4, 0, device=cuda)
    mops.mps_combine_fwd.launches = mops.mps_combine_bwd.launches = 0
    new, _, loss = step(params, opt.init(params), batch, 0)
    torch.cuda.synchronize()
    n_proj = lm.mps_param_count(cfg) * lm.n_superblocks(cfg)
    assert (mops.mps_combine_fwd.launches,
            mops.mps_combine_bwd.launches) == (2 * n_proj, n_proj)
    assert np.isfinite(float(loss)) and np.isfinite(float(step.grad_norm))
    assert all(torch.isfinite(t).all() for t in optimizers.tree_leaves(new))


def test_encdec_search_step_on_the_card(cuda):
    """One search step of ``seamless-m4t-medium-smoke`` (remat on) on the
    card from tokens and encoder frames: finite loss and gradient norm;
    K4's forward launched twice a projection of the encoder and the
    decoder's self attention and FFN (the recompute), its backward once;
    the cross projections take their raw weights and never reach K4."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import optimizers
    cfg = dataclasses.replace(registry.get("seamless-m4t-medium-smoke"),
                              remat=True)
    params = lm.init_params(cfg, device=cuda, mps_on=True)
    opt = optimizers.make_optimizer("adam", 3e-4)
    step = steps.make_train_step(cfg, opt, search=True)
    batch = synthetic.lm_batch(cfg.vocab, 65, 4, 0, device=cuda)
    g = torch.Generator(device="cuda").manual_seed(3)
    batch["enc_embeddings"] = (0.1 * torch.randn(4, 48, cfg.d_model,
                                                 generator=g, device=cuda)
                               ).to(torch.bfloat16)
    mops.mps_combine_fwd.launches = mops.mps_combine_bwd.launches = 0
    new, _, loss = step(params, opt.init(params), batch, 0)
    torch.cuda.synchronize()
    n_proj = 7 * (lm.n_superblocks(cfg) + lm.n_enc_superblocks(cfg))
    assert (mops.mps_combine_fwd.launches,
            mops.mps_combine_bwd.launches) == (2 * n_proj, n_proj)
    assert np.isfinite(float(loss)) and np.isfinite(float(step.grad_norm))
    assert all(torch.isfinite(t).all() for t in optimizers.tree_leaves(new))


def test_cnn_sweep_kill_resume_on_the_card(cuda, tmp_path):
    """A smoke-size cnn sweep (DS-CNN width 4, the reference test's spec)
    on the card under deterministic algorithms: killed in the second
    point's finetune and resumed, its store is byte-identical to the
    uninterrupted sweep's; every JointSearch step launched K4 forward and
    backward once a weight node."""
    import os

    from repro_torch import sweep
    from repro_torch.api import phases
    from repro_torch.models import cnn

    class Boom(phases.Hook):
        def __init__(self):
            self.finetunes, self.armed = 0, True

        def on_phase_start(self, phase, state):
            self.finetunes += phase.name == "finetune"

        def on_step(self, phase, state, step, metrics, train_state):
            if self.armed and phase.name == "finetune" and \
                    self.finetunes == 2:
                self.armed = False
                raise RuntimeError("boom")

    class SearchSteps(phases.Hook):
        n = 0

        def on_step(self, phase, state, step, metrics, train_state):
            SearchSteps.n += phase.name == "search"

    spec = sweep.SweepSpec(name="t", track="cnn", bench="gsc",
                           lams=(2.0, 12.0), adaptive_points=1,
                           warmup_steps=4, search_steps=4, finetune_steps=2,
                           batch=8, width=4, eval_batches=2,
                           checkpoint_every=2)

    def run(root, hooks=()):
        store = sweep.PlanStore(os.path.join(root, "store"))
        sweep.SweepRunner(spec, store, os.path.join(root, "work"),
                          verbose=False, device=cuda).run(hooks=hooks)
        entries = {n: open(store._entry_path(n), "rb").read()
                   for n in store.names()}
        return entries, [e["name"] for e in store.front()]

    old = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        mops.mps_combine_fwd.launches = mops.mps_combine_bwd.launches = 0
        ref = run(str(tmp_path / "a"), hooks=[SearchSteps()])
        n_nodes = len(cnn.dscnn(width=4).weight_nodes())
        assert mops.mps_combine_fwd.launches == \
            mops.mps_combine_bwd.launches == n_nodes * SearchSteps.n > 0
        with pytest.raises(RuntimeError, match="boom"):
            run(str(tmp_path / "b"), hooks=[Boom()])
        assert run(str(tmp_path / "b")) == ref
    finally:
        torch.use_deterministic_algorithms(False)
        if old is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old
