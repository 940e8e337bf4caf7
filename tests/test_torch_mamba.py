"""The port's Mamba-2 path against the JAX package on the CPU, from
numpy-seeded inputs: kernel K5's plain version against the reference's
``ssd_scan`` (oracle and interpret-mode Pallas kernel), the causal conv
and the SSD mixer against the jitted JAX functions on parameters carried
over by ``bridge``, the ``mamba2-780m-smoke`` LM's logits, greedy token
streams against the JAX ``InferenceServer`` (float and plan-bound), and
the SSM memory accounting.  The JAX side runs the dense backend only;
the JAX package's own tests hold its dense and paged streams equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro.configs import registry
from repro.kernels.ssd_scan import kernel as jssd_kernel
from repro.kernels.ssd_scan import ref as jssd_ref
from repro.models import lm as jlm
from repro.nn import blocks as jb
from repro.serve import cache as jcache
from repro.serve import engine as jeng
from repro.serve.sampling import SamplingParams as JSP
from repro.serve.scheduler import Request as JReq
from repro_torch.bridge import params_from_jax, tree_to_numpy
from repro_torch.kernels.ssd_scan import ops as tssd
from repro_torch.models import lm as tlm
from repro_torch.nn import blocks as tb
from repro_torch.serve import cache as tcache
from repro_torch.serve import engine as teng
from repro_torch.serve.sampling import SamplingParams as TSP
from repro_torch.serve.scheduler import Request as TReq
from torch_threads import _one_torch_thread  # noqa: F401

ARCH = "mamba2-780m-smoke"
KW = dict(max_len=48, max_batch=2)
SP = dict(max_tokens=4)


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16), \
        torch.as_tensor(a).to(torch.bfloat16)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if isinstance(a, jax.Array) else a.float().numpy()


# ---------------------------------------------------------------------------
# K5's plain version
# ---------------------------------------------------------------------------

def _scan_case(c, h, p, n, seed, zero_decay=False):
    rng = np.random.default_rng(seed)
    dec = rng.uniform(0.3, 1.0, size=(c, h)).astype(np.float32)
    if zero_decay:
        dec[:] = 0.0
    s_in = rng.normal(size=(c, h, p, n)).astype(np.float32)
    s0 = rng.normal(size=(h, p, n)).astype(np.float32)
    return dec, s_in, s0


@pytest.mark.parametrize("c,h,p,n,zero", [
    (4, 8, 16, 16, False), (6, 16, 8, 16, False), (1, 8, 4, 4, False),
    (10, 24, 16, 32, False), (5, 8, 4, 4, True)])
def test_ssd_scan_plain_matches_jax(c, h, p, n, zero):
    """The plain version against the reference's oracle and its
    interpret-mode Pallas kernel, within the reference's own 1e-5 (the
    shapes of ``tests/test_kernels.py``; a zero decay makes every prefix
    the previous chunk's input)."""
    dec, s_in, s0 = _scan_case(c, h, p, n, seed=c * h, zero_decay=zero)
    pt, ft = tssd.ssd_scan(*map(torch.as_tensor, (dec, s_in, s0)))
    args = tuple(map(jnp.asarray, (dec, s_in, s0)))
    for pj, fj in (jssd_ref.ssd_scan_ref(*args),
                   jssd_kernel.ssd_scan_fwd(*args, interpret=True)):
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5,
                                   atol=1e-5)
    if zero:
        np.testing.assert_array_equal(pt[1:].numpy(), s_in[:-1])
        np.testing.assert_array_equal(ft.numpy(), s_in[-1])


def test_ssd_scan_cpu_dispatch_and_checks():
    """A CPU tensor takes the plain version and counts no launch; a
    wrong dtype, shape or layout raises."""
    dec, s_in, s0 = map(torch.as_tensor, _scan_case(3, 2, 4, 4, seed=0))
    before = tssd.ssd_scan.launches
    prefix, final = tssd.ssd_scan(dec, s_in, s0)
    want = tssd.ssd_scan_ref(dec, s_in, s0)
    assert torch.equal(prefix, want[0]) and torch.equal(final, want[1])
    assert torch.equal(prefix[0], s0)
    assert tssd.ssd_scan.launches == before
    with pytest.raises(TypeError):
        tssd.ssd_scan(dec.double(), s_in, s0)
    with pytest.raises(ValueError):
        tssd.ssd_scan(dec, s_in, s0[:1])
    with pytest.raises(ValueError):
        tssd.ssd_scan(dec, s_in.transpose(2, 3), s0.transpose(1, 2))


# ---------------------------------------------------------------------------
# the mixer, on one smoke layer's parameters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    """Both packages' ``mamba2-780m-smoke`` weights (the JAX package's
    serving tests use key 1)."""
    cfg = registry.get(ARCH)
    jp = jlm.init_params(cfg, jax.random.key(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return cfg, jp, tp


@pytest.fixture(scope="module")
def layer(world):
    """Layer 0's mixer with its per-head vectors and conv kernels redrawn
    from numpy (the init's constants would hide a wrong broadcast)."""
    cfg, jp, _ = world
    pj = jax.tree.map(lambda a: a[0], jp["blocks"]["l0"]["mixer"])
    rng = np.random.default_rng(0)
    for k in ("dt_bias", "a_log", "d_skip", "ssm_norm", "conv_x",
              "conv_b", "conv_c"):
        pj[k] = jnp.asarray(rng.normal(size=pj[k].shape)
                            .astype(np.float32) * 0.5)
    return cfg, pj, params_from_jax(jax.tree.map(np.asarray, pj))


def _getw_j(pp):
    return pp["w"].astype(jnp.bfloat16)


def _getw_t(pp):
    return pp["w"].to(torch.bfloat16)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_causal_conv1d_bitwise(mode):
    """Bitwise in bf16: the prefill sums its taps one rounded op at a
    time in the reference's order; decode is one K-tap dot."""
    rng = np.random.default_rng(1)
    s = 1 if mode == "decode" else 33
    xj, xt = _bf16(rng.normal(size=(2, s, 48)).astype(np.float32))
    w = rng.normal(size=(4, 48)).astype(np.float32)
    st = rng.normal(size=(2, 3, 48)).astype(np.float32)
    sj, stt = _bf16(st)
    yj, nj = jax.jit(lambda x, w, c: jb._causal_conv1d(x, w, mode, c))(
        xj, jnp.asarray(w), sj)
    yt, nt = tb._causal_conv1d(xt, torch.as_tensor(w), mode, stt)
    assert yt.shape == yj.shape and nt.shape == nj.shape == (2, 3, 48)
    np.testing.assert_array_equal(_f32(yt), _f32(yj))
    np.testing.assert_array_equal(_f32(nt), _f32(nj))


def _state(rng, cfg, b):
    return {"ssm": rng.normal(size=(b, cfg.ssm_heads, cfg.ssm_head_dim,
                                    cfg.ssm_state)).astype(np.float32),
            "conv": {k: rng.normal(size=(b, cfg.ssm_conv - 1, c))
                     .astype(np.float32)
                     for k, c in (("x", cfg.d_inner), ("b", cfg.ssm_state),
                                  ("c", cfg.ssm_state))}}


def _close_bf16(got, want, what):
    """bf16 outputs: within one bf16 step at the largest magnitude, and
    at most 2% of the elements off at all.  The f32 sums inside run in
    another order (the port batches every chunk, the reference scans
    them, possibly FMA-contracted) and softplus is within an ULP, so a
    value close to a bf16 rounding boundary may round the other way."""
    g, w = _f32(got), _f32(want)
    np.testing.assert_allclose(g, w, rtol=0, atol=np.abs(w).max() * 2 ** -7,
                               err_msg=what)
    assert np.mean(g != w) <= 0.02, (what, np.mean(g != w))


def _close_state(got, want, what):
    """f32 SSM state: within 1e-5 of its largest magnitude (measured
    ~2e-6: f32 sums in another order)."""
    w = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), w, rtol=0,
                               atol=1e-5 * np.abs(w).max(), err_msg=what)


@jax.jit
def _jax_prefill(p, x, st):
    return jb.mamba2_layer(p, x, registry.get(ARCH), mode="prefill",
                           state=st, effective_w=_getw_j)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s", [32, 33, 64])
def test_mamba2_prefill_matches_jax(layer, s, carried):
    """Prefill at chunk 32 (one and two chunks) and at S = 33, whose
    chunk is 11: the output, the final SSM state (via K5's plain
    version) and the conv windows, from a zero or a carried state.  The
    port starts a fresh prompt from ``state=None``; the JAX side is
    handed an explicit all-zero state then, the same recurrence, so one
    compile per S serves both cases."""
    cfg, pj, pt = layer
    rng = np.random.default_rng(s + carried)
    xj, xt = _bf16(rng.normal(size=(2, s, cfg.d_model)).astype(np.float32))
    st = _state(rng, cfg, 2)
    if not carried:
        st = jax.tree.map(np.zeros_like, st)
    stj = {"ssm": jnp.asarray(st["ssm"]),
           "conv": {k: _bf16(v)[0] for k, v in st["conv"].items()}}
    stt = None
    if carried:
        stt = {"ssm": torch.as_tensor(st["ssm"]),
               "conv": {k: _bf16(v)[1] for k, v in st["conv"].items()}}
    yj, nj = _jax_prefill(pj, xj, stj)
    yt, nt = tb.mamba2_layer(pt, xt, cfg, mode="prefill", state=stt,
                             effective_w=_getw_t)
    assert yt.shape == yj.shape and yt.dtype == torch.bfloat16
    _close_bf16(yt, yj, f"y, S={s}")
    _close_state(nt["ssm"], nj["ssm"], f"ssm, S={s}")
    for k in "xbc":
        np.testing.assert_array_equal(_f32(nt["conv"][k]),
                                      _f32(nj["conv"][k]))


def test_mamba2_decode_matches_jax(layer):
    """Three decode steps from a carried state: output and state."""
    cfg, pj, pt = layer
    rng = np.random.default_rng(7)
    st = _state(rng, cfg, 2)
    stj = {"ssm": jnp.asarray(st["ssm"]),
           "conv": {k: _bf16(v)[0] for k, v in st["conv"].items()}}
    stt = {"ssm": torch.as_tensor(st["ssm"]),
           "conv": {k: _bf16(v)[1] for k, v in st["conv"].items()}}
    step = jax.jit(lambda p, x, st: jb.mamba2_layer(
        p, x, cfg, mode="decode", state=st, effective_w=_getw_j))
    for i in range(3):
        xj, xt = _bf16(rng.normal(size=(2, 1, cfg.d_model))
                       .astype(np.float32))
        yj, stj = step(pj, xj, stj)
        yt, stt = tb.mamba2_layer(pt, xt, cfg, mode="decode", state=stt,
                                  effective_w=_getw_t)
        _close_bf16(yt, yj, f"decode step {i}")
        _close_state(stt["ssm"], stj["ssm"], f"decode state {i}")


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

def test_bridge_carries_mamba_trees(world):
    """``params_from_jax`` carries the stacked mamba tree leaf for leaf:
    the same tree, shapes, dtypes and values."""
    cfg, jp, tp = world
    want = jax.tree.map(np.asarray, jp)
    got = tree_to_numpy(tp)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert set(tp["blocks"]["l0"]) == {"norm1", "mixer"}
    shapes = {k: tuple(v["w"].shape if isinstance(v, dict) else v.shape)
              for k, v in tp["blocks"]["l0"]["mixer"].items()}
    ref = tlm.init_params(cfg, device="cpu")["blocks"]["l0"]["mixer"]
    assert shapes == {k: tuple(v["w"].shape if isinstance(v, dict)
                               else v.shape) for k, v in ref.items()}


S0, N_DEC = 33, 8


def _jax_lm_logits(cfg, server, tokens):
    """Prefill through the JAX server's own jitted step, then teacher-
    forced decode steps."""
    params = server.params
    decode = jax.jit(lambda p, t, c, pos: jlm.decode_step(
        cfg, p, {"tokens": t}, c, pos))
    logits, caches = server._prefill(params, {"tokens": tokens[:, :S0]})
    out = [np.asarray(logits[:, -1].astype(jnp.float32))]
    for i in range(N_DEC):
        logits, caches = decode(params, jnp.asarray(
            tokens[:, S0 + i:S0 + i + 1]), caches,
            jnp.asarray([S0 + i], jnp.int32))
        out.append(np.asarray(logits[:, -1].astype(jnp.float32)))
    return np.stack(out)


def _torch_lm_logits(cfg, params, tokens):
    tok = torch.as_tensor(tokens)
    logits, caches = tlm.forward(cfg, params, {"tokens": tok[:, :S0]},
                                 mode="prefill", logits_mode="last")
    out = [logits[:, -1].float().numpy()]
    for i in range(N_DEC):
        logits, caches = tlm.decode_step(
            cfg, params, {"tokens": tok[:, S0 + i:S0 + i + 1]}, caches,
            torch.tensor([S0 + i], dtype=torch.int32))
        out.append(logits[:, -1].float().numpy())
    return np.stack(out)


@pytest.fixture(scope="module")
def jax_servers(world):
    """The JAX package's servers, dense backend: float, and bound to
    ``synthetic_plan(bits=None, seed=0)``."""
    cfg, jp, _ = world
    plan = jeng.synthetic_plan(cfg, jp, bits=None, seed=0)
    return {kind: jeng.InferenceServer(cfg, jp, plan=p, **KW)
            for kind, p in (("float", None), ("plan", plan))}


@pytest.mark.parametrize("plan_kind", ["float", "plan"])
def test_lm_logits_match_jax(world, jax_servers, plan_kind):
    """A 33-token prefill (chunk 11) and 8 teacher-forced decode steps:
    logits within ``2e-2 * max|logits|``, the bound the dense family's
    test states (bf16 compute; a planned projection's int8 activation
    quantization can turn a one-ulp bf16 difference into one integer
    step)."""
    cfg, jp, tp = world
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(1, S0 + N_DEC)).astype(np.int32)
    srv = jax_servers[plan_kind]
    if plan_kind == "float":
        tparams = tp
    else:
        jplan = srv.plan
        tplan = teng.synthetic_plan(cfg, tp, bits=None, seed=0)
        assert jplan.groups == tplan.groups and len(tplan.groups) == 12
        assert all(np.array_equal(jplan.channel_bits[g],
                                  tplan.channel_bits[g])
                   for g in jplan.groups)
        tparams = teng.apply_plan(cfg, tp, tplan)
    want = _jax_lm_logits(cfg, srv, tokens)
    got = _torch_lm_logits(cfg, tparams, tokens)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_decode_matches_own_forward(world):
    """The port's token-by-token decode against its own full prefill,
    the counterpart of ``test_lm_archs.TestDecodeConsistency`` with its
    tolerance (atol 0.15, rtol 0.05: bf16 activations, the chunked dual
    form against the one-step recurrence)."""
    cfg, _, tp = world
    b, s = 2, 32
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32))
    full, _ = tlm.forward(cfg, tp, {"tokens": toks}, mode="prefill")
    caches = tlm.init_caches(cfg, b, s, device="cpu")
    outs = []
    for i in range(s):
        logits, caches = tlm.decode_step(cfg, tp, {"tokens": toks[:, i:i + 1]},
                                         caches, torch.tensor(i))
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).float().numpy(),
                               full.float().numpy(), atol=0.15, rtol=0.05)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _workloads(cfg):
    """``test_serve``'s two 33-token prompts (seed 2) and ``test_cache``'s
    prompts of 33 and 17 tokens (seed 2)."""
    rng = np.random.default_rng(2)
    a = list(rng.integers(0, cfg.vocab, size=(2, 33)).astype(np.int32))
    rng = np.random.default_rng(2)
    b = [rng.integers(0, cfg.vocab, size=s).astype(np.int32)
         for s in (33, 17)]
    return {"serve": a, "cache": b}


def _serve(server, req_cls, sp_cls, prompts, uids=None):
    uids = range(len(prompts)) if uids is None else uids
    return server.serve([req_cls(uid=i, prompt=prompts[i],
                                 sampling=sp_cls(**SP)) for i in uids])


@pytest.fixture(scope="module")
def served(world, jax_servers):
    """The JAX package's greedy streams, float and plan-bound, on both
    workloads."""
    work = _workloads(world[0])
    ref = {(kind, name): _serve(srv, JReq, JSP, prompts)
           for kind, srv in jax_servers.items()
           for name, prompts in work.items()}
    return work, ref


@pytest.mark.parametrize("kind", ["float", "plan"])
def test_greedy_streams_equal_jax(world, served, kind):
    """The port's streams equal the JAX package's on both workloads,
    dense and paged; within the port dense == paged and batched == solo
    bitwise."""
    cfg, _, tp = world
    work, ref = served
    plan = None if kind == "float" else teng.synthetic_plan(
        cfg, tp, bits=None, seed=0)
    servers = {c: teng.InferenceServer(
        cfg, tp, plan=plan, device="cpu", cache=c,
        **KW, **({"page_size": 8} if c == "paged" else {}))
        for c in ("dense", "paged")}
    for name, prompts in work.items():
        for cache, srv in servers.items():
            out = _serve(srv, TReq, TSP, prompts)
            for i in range(len(prompts)):
                np.testing.assert_array_equal(
                    out[i], ref[kind, name][i],
                    err_msg=f"{kind}/{name}/{cache}/request {i}")
            for i in range(len(prompts)):
                solo = _serve(srv, TReq, TSP, prompts, uids=[i])
                np.testing.assert_array_equal(solo[i], out[i])


def test_memory_report_matches_jax(world):
    """``ssm_slot_bytes`` (18304 at the smoke size), the byte totals and
    the page counts equal the JAX package's backends under the same
    admissions: a pure-SSM stack takes no pages."""
    cfg, _, tp = world
    assert tlm.ssm_bytes_per_slot(cfg) == jlm.ssm_bytes_per_slot(cfg) \
        == 18304
    assert tlm.kv_bytes_per_token(cfg) == jlm.kv_bytes_per_token(cfg) == 0
    assert tlm.dense_cache_bytes(cfg, 2, 48) == \
        jlm.dense_cache_bytes(cfg, 2, 48)
    j = jcache.PagedCache(cfg, 2, 48, page_size=8)
    t = tcache.PagedCache(cfg, 2, 48, "cpu", page_size=8)
    reports = []
    for be in (j, t):
        h0 = be.alloc(0, 0, 33)
        h1 = be.alloc(1, 1, 17)
        for _ in range(9):
            be.append(h0)
            be.append(h1)
        mid = be.memory_report()
        be.free(h0)
        reports.append((mid, be.memory_report(),
                        be.can_admit(40), be.pages_for(40)))
    (jm, jend, jadm, jpg), (tm, tend, tadm, tpg) = reports
    keys = ("pages_in_use", "peak_pages_in_use", "n_pages", "pages_free",
            "bytes_per_page", "ssm_slot_bytes", "cache_bytes_in_use",
            "peak_cache_bytes", "pool_bytes", "dense_equivalent_bytes")
    for want, got in ((jm, tm), (jend, tend)):
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert tm["ssm_slot_bytes"] == 18304 and tm["peak_pages_in_use"] == 0
    assert (tadm, tpg) == (jadm, jpg) == (True, 0)
    srv = teng.InferenceServer(cfg, tp, device="cpu", cache="paged",
                               page_size=8, **KW)
    assert srv._paged and not srv._paged_kv
    _serve(srv, TReq, TSP, _workloads(cfg)["cache"])
    assert srv.stats["memory"]["peak_pages_in_use"] == 0
    assert srv.stats["memory"]["ssm_slot_bytes"] == 18304
