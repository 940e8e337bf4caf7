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
        caches = tlm.init_caches(cfg, b, max_len, "cpu")
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
