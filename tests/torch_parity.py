"""Helpers shared by the port's LM serving parity tests
(``test_torch_archs.py``, ``test_torch_moe.py``): the ``test_serve``
workload, both packages' servers, and the JAX package's K1 through its
plain reference.

The JAX package serves a planned projection through ``quant_matmul``,
the Pallas kernel in interpret mode off the TPU, which compiles for
seconds per shape.  :func:`jax_k1_plain` swaps in the kernel's plain
reference (``quant_matmul_ref`` on the unpacked weights) for the length
of a block.  The two are bitwise equal while a tile's integer sum stays
below 2^24 (the kernel accumulates in float32), which every smoke width
does: ``test_torch_archs.test_jax_k1_plain_equals_interpret_kernel``
holds them equal at the smoke archs' shapes.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels.quant_matmul import kernel as jqkernel
from repro.kernels.quant_matmul import ops as jqops
from repro.kernels.quant_matmul import ref as jqref
from repro.serve import engine as jeng
from repro.serve.sampling import SamplingParams as JSP
from repro.serve.scheduler import Request as JReq
from repro_torch.serve import engine as teng
from repro_torch.serve.sampling import SamplingParams as TSP
from repro_torch.serve.scheduler import Request as TReq

LENS = (6, 14, 9, 21)
N_TOKENS = 12
MAX_LEN = 48
PAGE = 8


def prompts(cfg, lens=LENS):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, size=s).astype(np.int32)
            for s in lens]


@functools.partial(jax.jit, static_argnames=("w_bits",))
def quant_matmul_plain(xq, wq_packed, sw, sx, w_bits=8):
    """``repro``'s ``quant_matmul`` through its plain reference."""
    wq = jqkernel._unpack(wq_packed, w_bits)[:, :xq.shape[1]]
    return jqref.quant_matmul_ref(xq, wq, sw, sx)


@contextlib.contextmanager
def jax_k1_plain():
    """Serve the JAX package's planned projections through K1's plain
    reference for the length of the block."""
    kernel = jqops.quant_matmul
    jqops.quant_matmul = quant_matmul_plain
    try:
        yield
    finally:
        jqops.quant_matmul = kernel


def _kw(cache, max_batch):
    kw = dict(max_len=MAX_LEN, max_batch=max_batch, cache=cache)
    if cache == "paged":
        kw["page_size"] = PAGE
    return kw


def serve_jax(cfg, params, cache, reqs, max_batch=2):
    """Greedy streams of ``reqs`` (``{uid: prompt}``) from the JAX
    package's server.  ``params`` may be a tree the caller bound to a plan
    (``engine.apply_plan``, what the server does with ``plan=``), so one
    binding serves several runs."""
    with jax_k1_plain():
        srv = jeng.InferenceServer(cfg, params, **_kw(cache, max_batch))
        return srv.serve([JReq(uid=u, prompt=p,
                               sampling=JSP(max_tokens=N_TOKENS))
                          for u, p in reqs.items()])


def serve_port(cfg, params, plan, cache, reqs, max_batch=2):
    """The same from the port's server, on the CPU."""
    srv = teng.InferenceServer(cfg, params, plan=plan, device="cpu",
                               **_kw(cache, max_batch))
    return srv.serve([TReq(uid=u, prompt=p,
                           sampling=TSP(max_tokens=N_TOKENS))
                      for u, p in reqs.items()])


def same_streams(got, want):
    """Per uid, whether the two servers' streams are equal."""
    return {u: np.array_equal(got[u], want[u]) for u in sorted(want)}


def jax_logits(cfg, params, tokens, s0, max_len=MAX_LEN):
    """Prefill of ``tokens[:, :s0]`` plus teacher-forced decode of the
    rest through the JAX package's dense path (jitted): (steps, B, V)."""
    from repro.models import lm as jlm
    with jax_k1_plain():
        prefill = jax.jit(lambda p, t: jlm.forward(
            cfg, p, {"tokens": t}, mode="prefill", logits_mode="last"))
        decode = jax.jit(lambda p, t, c, pos: jlm.decode_step(
            cfg, p, {"tokens": t}, c, pos))
        logits, pc = prefill(params, jnp.asarray(tokens[:, :s0]))
        caches = jlm.init_caches(cfg, tokens.shape[0], max_len)
        caches = jax.tree.map(
            lambda big, small: big.at[:, :, :s0].set(small), caches, pc)
        out = [np.asarray(logits[:, -1].astype(jnp.float32))]
        for i in range(s0, tokens.shape[1]):
            pos = jnp.full((tokens.shape[0],), i, jnp.int32)
            logits, caches = decode(params, jnp.asarray(tokens[:, i:i + 1]),
                                    caches, pos)
            out.append(np.asarray(logits[:, -1].astype(jnp.float32)))
    return np.stack(out)


def port_logits(cfg, params, tokens, s0, cache, max_len=MAX_LEN):
    """The same through the port's dense or paged path on the CPU; the
    paged prefill pads the prompt to a page boundary, as the server
    does."""
    from repro_torch.launch import steps
    from repro_torch.models import lm as tlm
    b = tokens.shape[0]
    tok = torch.as_tensor(tokens)
    if cache == "dense":
        logits, pc = steps.make_prefill_step(cfg)(params,
                                                  {"tokens": tok[:, :s0]})
        caches = tlm.init_caches(cfg, b, max_len, device="cpu")
        for ln, c in caches.items():
            for k, big in c["kv"].items():
                big[:, :, :s0] = pc[ln]["kv"][k]
        tables = None
    else:
        n = max_len // PAGE
        caches = tlm.init_paged_caches(cfg, b, PAGE, b * n, "cpu")
        tables = torch.arange(1, b * n + 1, dtype=torch.int32).reshape(b, n)
        spad = -(-s0 // PAGE) * PAGE
        padded = torch.zeros((b, spad), dtype=tok.dtype)
        padded[:, :s0] = tok[:, :s0]
        logits, caches = steps.make_paged_prefill_step(cfg)(
            params, {"tokens": padded}, caches, tables[:, :spad // PAGE],
            torch.full((b,), s0, dtype=torch.int32))
    decode = steps.make_decode_step(cfg)
    out = [logits[:, -1].float().numpy()]
    for i in range(s0, tokens.shape[1]):
        logits, caches = decode(params, {"tokens": tok[:, i:i + 1]}, caches,
                                torch.full((b,), i, dtype=torch.int32),
                                tables)
        out.append(logits[:, -1].float().numpy())
    return np.stack(out)


# ---------------------------------------------------------------------------
# enc-dec and VLM (ROADMAP C3): flat trees, greedy streams from any batch
# ---------------------------------------------------------------------------

def flat(tree, prefix=""):
    """``{"a/b": numpy}`` of a JAX or port tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    if torch.is_tensor(tree):
        return {prefix[:-1]: tree.detach().float().numpy()
                if tree.dtype == torch.bfloat16 else tree.detach().numpy()}
    return {prefix[:-1]: np.asarray(tree, np.float32)
            if tree.dtype == jnp.bfloat16 else np.asarray(tree)}


def to_torch(a):
    """A numpy array (ml_dtypes' bfloat16 too) as a CPU tensor."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _greedy_rows(logits, vocab):
    return np.argmax(np.asarray(logits)[:, -1, :vocab], axis=-1).astype(
        np.int32)


def jax_greedy(cfg, params, batch, n_new, max_len, enc_len=0):
    """A dense prefill of ``batch`` (numpy arrays: ``tokens`` or
    ``embeddings``, for enc-dec maybe ``enc_embeddings``) through the JAX
    package (jitted, K1 through its plain reference), its caches copied
    into ``init_caches(max_len, enc_len)``, then greedy decode.  Returns
    (tokens (B, n_new), logits (n_new, B, V) f32, the prefill's caches as
    numpy)."""
    from repro.models import lm as jlm
    with jax_k1_plain():
        prefill = jax.jit(lambda p, b: jlm.forward(
            cfg, p, b, mode="prefill", logits_mode="last"))
        decode = jax.jit(lambda p, t, c, pos: jlm.decode_step(
            cfg, p, {"tokens": t}, c, pos))
        logits, pc = prefill(params, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        key = "tokens" if "tokens" in batch else "embeddings"
        b, s = batch[key].shape[:2]
        caches = jlm.init_caches(cfg, b, max_len, enc_len=enc_len)
        caches = jax.tree.map(
            lambda big, small: big.at[:, :, :small.shape[2]].set(
                small.astype(big.dtype)), caches, pc)
        out = [np.asarray(logits[:, -1].astype(jnp.float32))]
        toks = [_greedy_rows(out[-1][:, None], cfg.vocab)]
        for i in range(n_new - 1):
            logits, caches = decode(params, jnp.asarray(toks[-1][:, None]),
                                    caches, jnp.full((b,), s + i, jnp.int32))
            out.append(np.asarray(logits[:, -1].astype(jnp.float32)))
            toks.append(_greedy_rows(out[-1][:, None], cfg.vocab))
    return np.stack(toks, 1), np.stack(out), jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)) if a.dtype ==
        jnp.bfloat16 else np.asarray(a), pc)


def port_greedy(cfg, params, batch, n_new, max_len, enc_len=0,
                cache="dense"):
    """The same through the port on the CPU, from a dense prefill or
    (``cache="paged"``, decoder-only) a paged one whose prompt is padded
    to a page boundary, as the server pads it.  Returns (tokens, logits,
    the dense prefill's caches or None)."""
    from repro_torch.launch import steps
    from repro_torch.models import lm as tlm
    tb = {k: to_torch(v) for k, v in batch.items()}
    key = "tokens" if "tokens" in tb else "embeddings"
    b, s = tb[key].shape[:2]
    pc = None
    with torch.no_grad():
        if cache == "dense":
            logits, pc = steps.make_prefill_step(cfg)(params, tb)
            caches = tlm.init_caches(cfg, b, max_len, enc_len=enc_len,
                                     device="cpu")

            def put(big, small):
                if isinstance(big, dict):
                    for k in big:
                        put(big[k], small[k])
                else:
                    big[:, :, :small.shape[2]] = small.to(big.dtype)
            put(caches, pc)
            tables = None
        else:
            n = max_len // PAGE
            caches = tlm.init_paged_caches(cfg, b, PAGE, b * n, "cpu")
            tables = torch.arange(1, b * n + 1,
                                  dtype=torch.int32).reshape(b, n)
            spad = -(-s // PAGE) * PAGE
            padded = {k: torch.cat([v, torch.zeros(
                (b, spad - s) + v.shape[2:], dtype=v.dtype)], 1)
                for k, v in tb.items()}
            logits, caches = steps.make_paged_prefill_step(cfg)(
                params, padded, caches, tables[:, :spad // PAGE],
                torch.full((b,), s, dtype=torch.int32))
        decode = steps.make_decode_step(cfg)
        out = [logits[:, -1].float().numpy()]
        toks = [_greedy_rows(out[-1][:, None], cfg.vocab)]
        for i in range(n_new - 1):
            logits, caches = decode(
                params, {"tokens": torch.as_tensor(toks[-1][:, None])},
                caches, torch.full((b,), s + i, dtype=torch.int32), tables)
            out.append(logits[:, -1].float().numpy())
            toks.append(_greedy_rows(out[-1][:, None], cfg.vocab))
    return np.stack(toks, 1), np.stack(out), pc


def numpy_lm_params(tcfg, seed=0):
    """An LM parameter tree of numpy arrays with ``repro.models.lm``'s
    paths and shapes, drawn by the port's ``init_params`` on the CPU from
    ``seed``: what ``bridge.lm_params_from_jax`` takes, and as jnp arrays
    what the JAX package computes with.  (The JAX package's eager
    ``init_params`` compiles every draw: ~7 s for jamba-smoke.)"""
    from repro_torch.bridge import tree_to_numpy
    from repro_torch.models import lm as tlm
    return tree_to_numpy(tlm.init_params(
        tcfg, torch.Generator().manual_seed(seed), device="cpu"))


def quarter_plans(jcfg, jparams, pw=(0, 2, 4, 8), seed=0):
    """The same mixed-precision plan in both packages over the JAX tree's
    plan groups: each group's channels take every precision of ``pw`` in
    equal shares, shuffled per group from ``seed``.  Groups of one width
    then share their per-precision row counts, so the JAX package's
    ``apply_plan`` packs each shape once (a seeded ``synthetic_plan``
    gives every group its own counts, and packing them there compiles
    for ~18 s at smoke size)."""
    from repro.api.plan import CompressionPlan as JPlan
    from repro.models import lm as jlm
    from repro_torch.api.plan import CompressionPlan as TPlan
    rng = np.random.default_rng(seed)
    gamma = {g: rng.permutation(np.resize(np.asarray(pw), w.shape[0]))
             .astype(np.int64)
             for g, w in jlm.serve_weight_groups(jcfg, jparams).items()}
    assignment = {"gamma": gamma, "delta": {}, "alpha": {}}
    return (JPlan.from_assignment(assignment, pw, (8,)),
            TPlan.from_assignment(assignment, pw, (8,)))


# ---------------------------------------------------------------------------
# observability (ROADMAP D12): what two packages' runs share
# ---------------------------------------------------------------------------

def obs_values(registry) -> dict:
    """A registry's counter and gauge values and its histograms' counts,
    by (metric, labels): everything but the wall clock (latency sums and
    buckets, ``compress_phase_seconds``)."""
    out = {}
    for name, m in registry.snapshot().items():
        if name == "compress_phase_seconds":
            continue
        for s in m["series"]:
            key = (name, tuple(sorted(s["labels"].items())))
            out[key] = s["count"] if m["kind"] == "histogram" \
                else s["value"]
    return out


def events_without_t(events) -> list:
    """Trace events (``TraceEvent`` objects or their JSON dicts) as
    dicts without the wall-clock ``t``."""
    out = []
    for ev in events:
        d = dict(ev if isinstance(ev, dict) else ev.to_json())
        d.pop("t")
        out.append(d)
    return out


class CountingClock:
    """A stand-in for a module's ``time``: ``perf_counter`` advances by
    1/1024 s a call, so two packages making the same calls read the same
    times (binary fractions: the differences are exact)."""

    def __init__(self):
        self.n = 0

    def perf_counter(self):
        self.n += 1
        return self.n / 1024.0


@contextlib.contextmanager
def counting_clocks(*modules):
    """Give each module its own :class:`CountingClock` as ``time`` for
    the length of the block."""
    saved = [m.time for m in modules]
    try:
        for m in modules:
            m.time = CountingClock()
        yield
    finally:
        for m, t in zip(modules, saved):
            m.time = t
