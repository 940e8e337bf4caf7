"""The port's hybrid (jamba) server against the JAX package's on
``jamba-1.5-large-398b-smoke`` (one super-block: 7 Mamba-2 layers and
one attention layer at slot 4, a dense FFN on the even slots, top-2 MoE
over 4 experts on the odd ones).  The model-level cases are
``test_torch_jamba.py``'s.

Three requests (prompts of 45, 12 and 45 tokens: 45 is above the smoke
``ssm_chunk`` 32 and not a multiple of it, so it prefills in chunks of
15) x 12 greedy tokens through ``max_batch`` 2, so the third request
queues.  A JAX server prefills at the exact prompt length and compiles
once a length, and the jamba graph compiles for seconds, so two JAX
servers carry the workload, both dense: a float one (its prefill also
gives the logits and caches held here, and it serves one host-sampled
run) and a plan-bound one on the two 45-token prompts, bound to
``torch_parity.quarter_plans``' mix of 0/4/8 bits (``test_torch_jamba.py``
holds the seed-0 ``synthetic_plan``'s groups and packing equal).  Each
of the port's four servers (dense and paged, float and plan-bound) is
held token for token against the JAX server of its mode: the JAX
package holds its own jamba dense and paged streams equal
(``tests/test_cache.py``).  At ``max_batch`` 2 no expert is ever over
capacity in a decode step, and a prefill runs one request alone, so the
streams depend neither on the backend nor on the batch.  The port's
page pool is held against the JAX package's ``PagedCache`` call for
call: every admission, page crossing, preemption and free of a served
run replayed on both gives the same pages.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_parity as tp_
from repro.configs import registry
from repro.nn import blocks as jb
from repro.serve import cache as jcache
from repro.serve import engine as jeng
from repro.serve.sampling import SamplingParams as JSP
from repro.serve.scheduler import Request as JReq
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import registry as treg
from repro_torch.launch import steps
from repro_torch.nn import blocks as tb
from repro_torch.serve import cache as tcache
from repro_torch.serve import engine as teng
from repro_torch.serve.sampling import SamplingParams as TSP
from repro_torch.serve.scheduler import Request as TReq
from torch_threads import _one_torch_thread  # noqa: F401

ARCH = "jamba-1.5-large-398b-smoke"
LENS = (45, 12, 45)
KW = dict(max_len=64, max_batch=2)
UIDS = {"float": (0, 1, 2), "plan": (0, 2)}    # the requests of a mode
GREEDY = dict(max_tokens=12)
HOST = dict(temperature=0.8, top_k=12, max_tokens=12, seed=11)


def _kw(cache):
    return dict(KW, cache=cache, **(
        {"page_size": 16} if cache == "paged" else {}))


def _reqs(cls, sp_cls, prompts, sp, uids):
    return [cls(uid=i, prompt=prompts[i], sampling=sp_cls(**sp))
            for i in uids]


def _run(server, reqs):
    """Serve step by step: (streams, the uids each step admitted)."""
    server.begin(reqs)
    admitted = []
    while server.has_work:
        admitted.append(list(server.step().admitted))
    return server.end(), admitted


@pytest.fixture(scope="module")
def world():
    """Both packages' weights (one numpy tree) and plans, and the JAX
    package's runs: the float server's greedy and host-sampled streams
    and its prefill of each prompt length, the plan-bound server's
    greedy streams.  The float server is compiled with a debug callback
    on its MoE layers' inputs, which records them during its 45-token
    prefill alone (``test_45_token_gap_is_one_norm_rounding``)."""
    cfg, tcfg = registry.get(ARCH), treg.get(ARCH)
    tree = tp_.numpy_lm_params(tcfg)
    tp = lm_params_from_jax(tree, cfg=tcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    jplan, tplan = tp_.quarter_plans(cfg, jp, pw=(0, 4, 8))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=s).astype(np.int32)
               for s in LENS]
    ref, moe_in, armed = {"moe_in": []}, jb._moe_local, []

    def recorded(x, *a, **k):
        jax.debug.callback(
            lambda v: armed and ref["moe_in"].append(np.asarray(v)),
            x.astype(jnp.float32), ordered=True)
        return moe_in(x, *a, **k)

    with tp_.jax_k1_plain(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jb, "_moe_local", recorded)
        srv = jeng.InferenceServer(cfg, jp, **_kw("dense"))
        ref["float"] = _run(srv, _reqs(JReq, JSP, prompts, GREEDY,
                                       UIDS["float"]))
        # the server's own jitted prefill, compiled for both lengths
        armed.append(True)
        ref["prefill"] = {45: srv._prefill(jp, {"tokens": prompts[0][None]})}
        jax.effects_barrier()
        armed.clear()
        ref["prefill"][12] = srv._prefill(jp, {"tokens": prompts[1][None]})
        srv.sample_on_device = False
        ref["host"] = srv.serve(_reqs(JReq, JSP, prompts, HOST, (1,)))
    with tp_.jax_k1_plain():
        srv = jeng.InferenceServer(cfg, jeng.apply_plan(cfg, jp, jplan),
                                   **_kw("dense"))
        ref["plan"] = _run(srv, _reqs(JReq, JSP, prompts, GREEDY,
                                      UIDS["plan"]))
    return dict(cfg=cfg, tcfg=tcfg, tp=tp, jp=jp, prompts=prompts, ref=ref,
                plans={"float": None, "plan": tplan})


@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["float", "plan"])
def test_greedy_streams_equal_jax(world, mode, cache):
    """Identical streams and admission order at every step, dense and
    paged; the paged server prefills the hybrid unpadded
    (``_has_ssm``)."""
    srv = teng.InferenceServer(world["tcfg"], world["tp"],
                               plan=world["plans"][mode], device="cpu",
                               **_kw(cache))
    assert srv._paged_kv == (cache == "paged") and srv._has_ssm
    uids = UIDS[mode]
    got, admitted = _run(srv, _reqs(TReq, TSP, world["prompts"], GREEDY,
                                    uids))
    want, want_admitted = world["ref"][mode]
    assert tp_.same_streams(got, want) == {u: True for u in uids}
    assert admitted == want_admitted and admitted[0] == list(uids[:2])
    if mode == "float":
        assert [2] in admitted                  # the queued request
    if cache == "paged":
        assert srv.stats["memory"]["peak_pages_in_use"] > 0


@pytest.mark.parametrize("s", [45, 12])
def test_prefill_logits_and_caches_match_jax(world, s):
    """The JAX server's dense prefill of a prompt against the port's: the
    last position's logits, the attention layer's K/V and the Mamba-2
    conv windows within ``2e-2 * max|x|`` each (the dense family's
    logits bound); the SSM states of the Mamba-2 layers before the
    attention layer within 1e-5 relative L2, of those after it within
    5e-2.  At one SSD chunk (12 tokens) logits and K/V are bitwise and
    every state within 1e-6.  At 45 tokens one bf16 value of the MoE
    input at slot 3 rounds the other way, and the attention layer and
    slot 5's top-2 routing carry that on
    (``test_45_token_gap_is_one_norm_rounding``; measured: the logits
    within 0.81% of their max, states 0-3 within 6.1e-7 and 5-7 within
    4.1e-2 relative L2, conv windows within 1.7% of their max)."""
    tok = world["prompts"][LENS.index(s)][None]
    jl, jc = world["ref"]["prefill"][s]
    with torch.no_grad():
        tl, tc = steps.make_prefill_step(world["tcfg"])(
            world["tp"], {"tokens": torch.as_tensor(tok)})
    want = {"logits": np.asarray(jl.astype(jnp.float32)), **tp_.flat(jc)}
    got = {"logits": tl.float().numpy(), **tp_.flat(tc)}
    assert sorted(got) == sorted(want)
    assert {k for k in got if k.endswith("/mamba/ssm")} == \
        {f"l{i}/mamba/ssm" for i in range(8) if i != 4}
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        if k.endswith("/ssm"):
            bound = 1e-6 if s == 12 else 1e-5 if k < "l4" else 5e-2
            assert tp_.rel(got[k], w) <= bound, (k, tp_.rel(got[k], w))
        else:
            np.testing.assert_allclose(got[k], w, rtol=0, err_msg=k,
                                       atol=2e-2 * np.abs(w).max())
    if s == 12:
        for k in ("logits", "l4/kv/k", "l4/kv/v"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_45_token_gap_is_one_norm_rounding(world, monkeypatch):
    """Where the 45-token prefill parts from the reference, and why the
    states after the attention layer differ by 4e-2.  The inputs of both
    packages' MoE layers are recorded (the JAX float server's through
    the fixture's debug callback).  Slot 1's MoE input is bitwise; slot 3's
    differs in one bf16 value (token 9), one bf16 step apart: the
    RMSNorm before it sums its mean of squares in another f32 order than
    XLA, and the normalised value sits on a bf16 rounding tie.  With
    that one value taken from the reference, the logits and K/V are
    bitwise and every SSM state is within 1e-4 relative L2 (measured
    2.2e-5).  Without it, the attention layer spreads token 9's
    difference to the 35 tokens after it, and slot 5's top-2 choice
    flips at tokens 36 and 40."""
    tok = world["prompts"][LENS.index(45)][None]
    jl, jc = world["ref"]["prefill"][45]
    jrec, trec = world["ref"]["moe_in"], []
    inner_t = tb._moe_local

    def rec_t(x, *a, **k):
        trec.append(x)
        if sub is not None and len(trec) == 2:
            x = sub
        return inner_t(x, *a, **k)

    monkeypatch.setattr(tb, "_moe_local", rec_t)
    step = steps.make_prefill_step(world["tcfg"])
    sub = None
    with torch.no_grad():
        tl, tc = step(world["tp"], {"tokens": torch.as_tensor(tok)})
    assert len(jrec) == len(trec) == 4             # the MoE slots 1, 3, 5, 7
    got = [x.float().numpy() for x in trec]
    want = [j.reshape(g.shape) for j, g in zip(jrec, got)]
    np.testing.assert_array_equal(got[0], want[0])
    diff = np.argwhere(got[1] != want[1])
    assert diff.tolist() == [[9, diff[0][1]]]
    v = want[1][9, diff[0][1]]
    step_bf16 = 2.0 ** (np.floor(np.log2(abs(v))) - 7)
    assert abs(got[1][9, diff[0][1]] - v) == step_bf16
    wrong = {int(np.abs(a - b).max(-1).nonzero()[0].min())
             for a, b in zip(got[2:], want[2:])}
    assert wrong == {9}                            # token 9 onwards
    rw = world["tp"]["blocks"]["l5"]["ffn"]["router"]["w"][0]
    cfg = world["tcfg"]
    cap = math.ceil(45 * cfg.experts_per_token * cfg.capacity_factor
                    / cfg.n_experts)
    ids = [tb.moe_route(torch.tensor(x).to(trec[2].dtype), rw, top_k=2,
                        capacity=cap)[1] for x in (got[2], want[2])]
    assert (ids[0] != ids[1]).any(-1).nonzero().flatten().tolist() == [36, 40]

    sub = torch.tensor(want[1]).to(trec[1].dtype)
    trec.clear()
    with torch.no_grad():
        tl, tc = step(world["tp"], {"tokens": torch.as_tensor(tok)})
    np.testing.assert_array_equal(tl.float().numpy(),
                                  np.asarray(jl.astype(jnp.float32)))
    jf, tf = tp_.flat(jc), tp_.flat(tc)
    for k, w in jf.items():
        if "/kv/" in k:
            np.testing.assert_array_equal(tf[k], w, err_msg=k)
        elif k.endswith("/ssm"):
            assert tp_.rel(tf[k], w) <= 1e-4, (k, tp_.rel(tf[k], w))


def test_host_sampled_stream_equals_jax(world):
    """Temperature 0.8, top-k 12, sampled on the host from the seeded
    numpy generator: the same tokens as the JAX server's.  The request
    is the 12-token prompt, one SSD chunk, whose prefill logits equal the
    reference's bit for bit; a 45-token prompt's logits are not (one
    RMSNorm output rounds the other way,
    ``test_45_token_gap_is_one_norm_rounding``), and one bf16 step in a
    logit moves a sampled token (ROADMAP section 3)."""
    srv = teng.InferenceServer(world["tcfg"], world["tp"], device="cpu",
                               sample_on_device=False, **_kw("paged"))
    got = srv.serve(_reqs(TReq, TSP, world["prompts"], HOST, (1,)))
    assert tp_.same_streams(got, world["ref"]["host"]) == {1: True}
    assert not np.array_equal(got[1], world["ref"]["float"][0][1])


def _mirror(port, ref):
    """Replay every call the port's ``PagedCache`` takes on the JAX
    package's (the same arguments, its own handles) and hold the two
    equal after each: the same result or the same ``PoolExhausted``, the
    same host block tables and the same free pages."""
    handles = {}

    def wrap(name):
        tf, jf = getattr(port, name), getattr(ref, name)

        def call(*args):
            jargs = [handles[id(a)] if isinstance(a, tcache.CacheHandle)
                     else a for a in args]
            jerr = terr = None
            try:
                jout = jf(*jargs)
            except jcache.PoolExhausted as e:
                jerr = e
            try:
                tout = tf(*args)
            except tcache.PoolExhausted as e:
                terr = e
            assert (jerr is None) == (terr is None), (name, jerr, terr)
            np.testing.assert_array_equal(port._table, ref._table)
            assert list(port._free) == list(ref._free), name
            if terr is not None:
                raise terr
            if name == "alloc":
                assert tout.pages == jout.pages
                handles[id(tout)] = jout
            elif name in ("can_admit", "shrink_pool"):
                assert tout == jout, name
            return tout

        setattr(port, name, call)

    for name in ("alloc", "append", "free", "can_admit", "shrink_pool",
                 "reset"):
        wrap(name)


def test_page_pool_and_preemption_equal_jax(world):
    """Requests 0 and 1 on 5 of the pool's 8 pages (3 withheld): request
    1 is preempted when request 0 crosses into its fourth page, and
    resumes by prefilling its prompt and the tokens it had (recompute).
    Every pool call (admission, page crossing, the preemption, frees)
    leaves the port's pages and tables equal to the JAX package's, and
    the streams equal the uninterrupted run's.  (A hybrid's resumed
    stream need not: the recompute runs the chunked SSD and the MoE's
    prefill capacity where decode ran the one-token recurrence, in both
    packages; ROADMAP section 3, quirks kept.)"""
    cfg, tcfg = world["cfg"], world["tcfg"]
    srv = teng.InferenceServer(tcfg, world["tp"], device="cpu",
                               **_kw("paged"))
    _mirror(srv.backend, jcache.PagedCache(cfg, KW["max_batch"],
                                           KW["max_len"], page_size=16))
    srv.begin(_reqs(TReq, TSP, world["prompts"], GREEDY, (0, 1)))
    assert srv.backend.shrink_pool(3) == 3
    while srv.has_work:
        srv.step()
    got = srv.end()
    assert srv.stats["preemptions"] > 0
    whole = world["ref"]["float"][0]
    assert tp_.same_streams(got, {u: whole[u] for u in got}) == \
        {0: True, 1: True}
