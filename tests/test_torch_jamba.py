"""The port's hybrid (jamba) model against the JAX package on the CPU, on
``jamba-1.5-large-398b-smoke`` (one super-block of 8 layers: Mamba-2 on
every slot but 4, attention on slot 4; a dense FFN on the even slots,
top-2 MoE over 4 experts with no dense residual on the odd ones), from
the same seeded inputs: the pattern and the parameter tree, the bridge's
checks, the seed-0 synthetic plan's groups and packed buffers, decode
against the port's own prefill, one Mamba-2 layer with bf16 parameters
(the published dtype), the exact-length paged prefill and why it exists,
the cache accounting, the training refusal and the launcher.  Both
packages compute with one numpy tree (``torch_parity.numpy_lm_params``,
carried into the port by ``bridge.lm_params_from_jax``).  Prefill logits
and caches, the servers' token streams and the page pool are
``test_torch_jamba_serve.py``'s."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_parity as tp_
from repro.configs import registry
from repro.models import lm as jlm
from repro.nn import blocks as jb
from repro.serve import cache as jcache
from repro.serve import engine as jeng
from repro_torch.bridge import lm_params_from_jax, params_from_jax
from repro_torch.configs import registry as treg
from repro_torch.launch import steps
from repro_torch.models import lm as tlm
from repro_torch.nn import blocks as tb
from repro_torch.serve import cache as tcache
from repro_torch.serve import engine as teng
from repro_torch.serve.sampling import SamplingParams as TSP
from repro_torch.serve.scheduler import Request as TReq
from torch_threads import _one_torch_thread  # noqa: F401

ARCH = "jamba-1.5-large-398b-smoke"
LENS = (12, 45)       # one SSD chunk; three chunks of 15


@pytest.fixture(scope="module")
def world():
    """Both configs, the shared numpy tree as jnp arrays (the JAX
    package's) and through the bridge (the port's)."""
    cfg, tcfg = registry.get(ARCH), treg.get(ARCH)
    tree = tp_.numpy_lm_params(tcfg)
    return cfg, tcfg, jax.tree.map(jnp.asarray, tree), \
        lm_params_from_jax(tree, cfg=tcfg)


def _tokens(cfg, s, b=2):
    return np.random.default_rng(s).integers(0, cfg.vocab, size=(b, s)) \
        .astype(np.int32)


# ---------------------------------------------------------------------------
# the pattern, the tree, the bridge and the plan
# ---------------------------------------------------------------------------

def test_pattern_and_tree_match_jax(world):
    """``block_pattern`` is the reference's (1:7 attention:Mamba-2,
    attention at slot ``attn_every // 2``, MoE on the odd slots), and
    the tree's paths, shapes and dtypes are its too, with the search's
    gammas and without; every Mamba-2 layer carries ``norm2`` and an
    FFN."""
    cfg, tcfg, _, _ = world
    pat = tlm.block_pattern(tcfg)
    assert [(p.mixer, p.ffn) for p in pat] == \
        [(p.mixer, p.ffn) for p in jlm.block_pattern(cfg)]
    assert [p.mixer for p in pat].count("mamba") == 7 and \
        pat[4].mixer == "attn"
    assert [p.ffn for p in pat] == ["dense", "moe"] * 4
    for mps_on in (False, True):
        jt = jax.tree_util.tree_flatten_with_path(
            jlm.abstract_params(cfg, mps_on=mps_on))[0]
        want = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
                for p, a in jt}
        got = {}

        def walk(t, path):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{path}['{k}']")
            else:
                got[path] = (tuple(t.shape), str(t.dtype).split(".")[-1])

        walk(tlm.init_params(tcfg, device="meta", mps_on=mps_on), "")
        assert got == want
    assert tlm.mps_param_count(tcfg) == jlm.mps_param_count(cfg)
    for i, spec in enumerate(pat):
        assert {"norm2", "ffn"} <= set(world[3]["blocks"][f"l{i}"])
    assert tlm.kv_bytes_per_token(tcfg) == jlm.kv_bytes_per_token(cfg) > 0
    assert tlm.ssm_bytes_per_slot(tcfg) == jlm.ssm_bytes_per_slot(cfg) > 0


def _moved(tree, what):
    blocks = tree["blocks"]
    if what == "mamba without norm2":
        del blocks["l0"]["norm2"]
    elif what == "mamba without ffn":
        del blocks["l2"]["ffn"]
    elif what == "bank on an even slot":
        blocks["l0"]["ffn"], blocks["l1"]["ffn"] = \
            blocks["l1"]["ffn"], blocks["l0"]["ffn"]
    return tree


@pytest.mark.parametrize("what", ["mamba without norm2", "mamba without ffn",
                                  "bank on an even slot", "bf16 leaves"])
def test_bridge_checks_the_hybrid_tree(world, what):
    """``lm_params_from_jax`` takes the hybrid tree (and carries bf16
    leaves, the published dtype, bit for bit) and rejects one whose
    Mamba-2 layer lacks ``norm2`` or its FFN, or whose expert bank sits
    on an even slot."""
    cfg, tcfg, jp, _ = world
    tree = jax.tree.map(np.asarray, jp)
    if what == "bf16 leaves":
        tree = jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)
        got = lm_params_from_jax(tree, cfg=tcfg)
        leaf = got["blocks"]["l1"]["ffn"]["w_up"]["w"]
        assert leaf.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            leaf.float().numpy(), tree["blocks"]["l1"]["ffn"]["w_up"]["w"]
            .astype(np.float32))
        return
    with pytest.raises(ValueError, match="blocks.l[0-2]"):
        lm_params_from_jax(_moved(tree, what), cfg=tcfg)


def test_synthetic_plan_and_packing_equal_jax(world):
    """``synthetic_plan(bits=None, seed=0)``: the same 58 groups (7 x 6
    Mamba-2, 4 attention, 4 x 3 dense FFN; the routers and expert banks
    are none), bits and permutations.  Packed buffers and scales are
    identical on three groups: a Mamba-2 input and its narrow ``in_dt``
    and a dense FFN's down projection (the JAX package's packing compiles
    per group shape, ~35 s for all 58)."""
    cfg, tcfg, jp, tp = world
    jplan = jeng.synthetic_plan(cfg, jp, bits=None, seed=0)
    tplan = teng.synthetic_plan(tcfg, tp, bits=None, seed=0)
    assert jplan.groups == tplan.groups and len(tplan.groups) == 58
    assert not any("router" in g or (".ffn.w_" in g and
                                     int(g.split(".")[1][1:]) % 2)
                   for g in tplan.groups)
    for g in jplan.groups:
        np.testing.assert_array_equal(jplan.channel_bits[g],
                                      tplan.channel_bits[g])
        np.testing.assert_array_equal(jplan.permutations[g],
                                      tplan.permutations[g])
    jw, tw = jlm.serve_weight_groups(cfg, jp), \
        tlm.serve_weight_groups(tcfg, tp)
    pick = [f"blocks.{g}.sb0" for g in ("l0.mixer.in_x", "l1.mixer.in_dt",
                                         "l6.ffn.w_down")]
    jpk = jeng.export_plan_layers(jplan, {g: jw[g] for g in pick})
    tpk = teng.export_plan_layers(tplan, {g: tw[g] for g in pick})
    for g in pick:
        (jl, jperm, jkept), (tl, tperm, tkept) = jpk[g], tpk[g]
        np.testing.assert_array_equal(np.asarray(tperm), np.asarray(jperm))
        assert int(tkept) == int(jkept) and len(tl) == len(jl) > 1, g
        for (tb_, tw_, ts), (jb_, jw_, js) in zip(tl, jl):
            assert tb_ == jb_, g
            np.testing.assert_array_equal(tw_.numpy(), np.asarray(jw_))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def test_decode_matches_own_prefill(world):
    """Token-by-token decode against the port's own full prefill, the
    counterpart of ``test_lm_archs.TestDecodeConsistency``'s jamba case
    (its tolerance: atol 0.15, rtol 0.05).  The reference compares with
    ``mode="train"``, which the port refuses for an MoE stack."""
    _, tcfg, _, tp = world
    b, s = 2, 32
    toks = torch.as_tensor(_tokens(tcfg, s))
    with torch.no_grad():
        full, _ = tlm.forward(tcfg, tp, {"tokens": toks}, mode="prefill")
        caches = tlm.init_caches(tcfg, b, s, device="cpu")
        outs = []
        for i in range(s):
            logits, caches = tlm.decode_step(
                tcfg, tp, {"tokens": toks[:, i:i + 1]}, caches,
                torch.tensor(i))
            outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).float().numpy(),
                               full.float().numpy(), atol=0.15, rtol=0.05)


def test_bf16_mamba_layer_matches_jax(world):
    """One Mamba-2 layer with bf16 parameters (jamba's published dtype:
    projections, conv kernels, ``dt_bias``, ``a_log``, ``d_skip`` and
    ``ssm_norm`` in bf16; the smoke size is float32), its per-head
    vectors and conv kernels redrawn from numpy: prefill at 12 and 45
    tokens, then one decode step from the JAX state.  ``silu_f32`` and
    the unrounded gate hold here too.  Outputs within one bf16 step at
    the largest magnitude with at most 2% of them off (measured: 0 at
    these inputs; at other lengths and draws up to 6% of the outputs one
    step off, the f32 chunk sums' order, ROADMAP section 3), SSM states
    within 1e-5 of their largest magnitude."""
    cfg = dataclasses.replace(world[0], param_dtype="bfloat16")
    pj = jax.tree.map(lambda a: a[0].astype(jnp.bfloat16),
                      world[2]["blocks"]["l0"]["mixer"])
    rng = np.random.default_rng(0)
    for k in ("dt_bias", "a_log", "d_skip", "ssm_norm", "conv_x", "conv_b",
              "conv_c"):
        pj[k] = jnp.asarray(rng.normal(size=pj[k].shape).astype(np.float32)
                            * 0.5).astype(jnp.bfloat16)
    pt = params_from_jax(jax.tree.map(np.asarray, pj))
    assert pt["a_log"].dtype == pt["in_x"]["w"].dtype == torch.bfloat16
    gj = lambda pp: pp["w"].astype(jnp.bfloat16)        # noqa: E731
    gt = lambda pp: pp["w"].to(torch.bfloat16)          # noqa: E731
    prefill = jax.jit(lambda p, x: jb.mamba2_layer(
        p, x, cfg, mode="prefill", effective_w=gj))
    decode = jax.jit(lambda p, x, st: jb.mamba2_layer(
        p, x, cfg, mode="decode", state=st, effective_w=gj))

    def close(got, want, what):
        g, w = tp_.flat({"x": got})["x"], tp_.flat({"x": want})["x"]
        np.testing.assert_allclose(g, w, rtol=0, err_msg=what,
                                   atol=np.abs(w).max() * 2 ** -7)
        assert np.mean(g != w) <= 0.02, (what, np.mean(g != w))

    for s in LENS:
        x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
        yj, nj = prefill(pj, jnp.asarray(x).astype(jnp.bfloat16))
        with torch.no_grad():
            yt, nt = tb.mamba2_layer(pt, tp_.to_torch(x).to(torch.bfloat16),
                                     cfg, mode="prefill", effective_w=gt)
        assert yt.dtype == torch.bfloat16
        close(yt, yj, f"prefill y, S={s}")
        w = np.asarray(nj["ssm"])
        np.testing.assert_allclose(nt["ssm"].numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
        x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        yj, _ = decode(pj, jnp.asarray(x1).astype(jnp.bfloat16), nj)
        with torch.no_grad():
            yt, _ = tb.mamba2_layer(
                pt, tp_.to_torch(x1).to(torch.bfloat16), cfg, mode="decode",
                state={"ssm": tp_.to_torch(nj["ssm"]),
                       "conv": {k: tp_.to_torch(v)
                                for k, v in nj["conv"].items()}},
                effective_w=gt)
        close(yt, yj, f"decode y after S={s}")


def test_train_mode_runs_the_hybrid(world):
    """The hybrid trains (the refusal that named slice E is gone): the
    train-mode forward of a sequence the SSD chunk tiles gives finite
    logits, and the loss's gradient reaches a Mamba-2 layer, the
    attention layer and every MoE slot's router and banks (parity with
    the JAX package: ``test_torch_hybrid_train.py``)."""
    _, tcfg, _, tp = world
    tok = torch.zeros((1, 32), dtype=torch.int32)
    logits, caches = tlm.forward(tcfg, tp, {"tokens": tok}, mode="train")
    assert caches is None and torch.isfinite(logits).all()
    blk = tp["blocks"]
    leaves = [blk["l0"]["mixer"]["in_x"]["w"], blk["l4"]["mixer"]["wq"]["w"]]
    for i in (1, 3, 5, 7):
        leaves += [blk[f"l{i}"]["ffn"]["router"]["w"],
                   blk[f"l{i}"]["ffn"]["w_up"]["w"]]
    leaves = [t.detach().requires_grad_() for t in leaves]
    params = {**tp, "blocks": {k: dict(v) for k, v in blk.items()}}
    params["blocks"]["l0"]["mixer"] = {**blk["l0"]["mixer"],
                                       "in_x": {"w": leaves[0]}}
    params["blocks"]["l4"]["mixer"] = {**blk["l4"]["mixer"],
                                       "wq": {"w": leaves[1]}}
    for n, i in enumerate((1, 3, 5, 7)):
        params["blocks"][f"l{i}"]["ffn"] = {
            **blk[f"l{i}"]["ffn"], "router": {"w": leaves[2 + 2 * n]},
            "w_up": {"w": leaves[3 + 2 * n]}}
    loss = tlm.loss_fn(tcfg, params, {"tokens": tok, "targets": tok})
    for g in torch.autograd.grad(loss, leaves):
        assert torch.isfinite(g).all() and g.abs().sum() > 0


# ---------------------------------------------------------------------------
# the paged cache and the server (the port alone)
# ---------------------------------------------------------------------------

def _paged_prefill(tcfg, tp, tok, spad):
    """The paged prefill step over a fresh 1-slot pool, the prompt padded
    with zeros to ``spad`` tokens, as the server's attention-only branch
    pads it."""
    s = tok.shape[1]
    cache = tcache.PagedCache(tcfg, 1, 64, "cpu", page_size=16)
    h = cache.alloc(0, 0, s)
    padded = torch.zeros((1, spad), dtype=torch.int32)
    padded[:, :s] = torch.as_tensor(tok)
    width = -(-spad // 16)
    with torch.no_grad():
        logits, pc = steps.make_paged_prefill_step(tcfg)(
            tp, {"tokens": padded}, cache.kv_caches(),
            cache.device_tables()[:1, :width],
            torch.tensor([s], dtype=torch.int32))
    return cache, h, logits, pc


def test_padding_would_change_the_ssm_state(world):
    """Why the hybrid prefills at its exact length: a 45-token prompt
    padded to the q-chunk boundary (48) reads the same logits at its last
    real token (every layer is causal), but the Mamba-2 layers carry the
    three padding tokens into the state that decode starts from.  The
    paged step is handed only the KV pools and returns each Mamba-2
    layer's (nsb, 1, ...) state beside them; ``insert`` puts that state
    in the slot's row, as the dense backend's ``insert`` puts the dense
    prefill's."""
    cfg, tcfg, _, tp = world
    tok = _tokens(cfg, 45, b=1)
    cache, h, exact, pc = _paged_prefill(tcfg, tp, tok, 45)
    _, _, padded, pc_pad = _paged_prefill(tcfg, tp, tok, 48)
    assert sorted(cache.kv_caches()) == ["l4"]
    assert sorted(pc) == [f"l{i}" for i in range(8)]
    np.testing.assert_allclose(padded.float().numpy(),
                               exact.float().numpy(), rtol=0,
                               atol=2e-2 * exact.float().abs().max().item())
    for i in (0, 1, 2, 3, 5, 6, 7):
        a = pc[f"l{i}"]["mamba"]["ssm"]
        b = pc_pad[f"l{i}"]["mamba"]["ssm"]
        assert a.shape == (1, 1, tcfg.ssm_heads, tcfg.ssm_head_dim,
                           tcfg.ssm_state)
        assert ((a - b).norm() / a.norm()).item() > 1e-2, i
    cache.insert(h, pc)
    dense = tcache.DenseCache(tcfg, 1, 64, "cpu")
    with torch.no_grad():
        _, dc = steps.make_prefill_step(tcfg)(
            tp, {"tokens": torch.as_tensor(tok)})
    dense.insert(dense.alloc(0, 0, 45), dc)
    for i in (0, 1, 2, 3):       # before the attention layer: bitwise
        for k, v in tp_.flat(cache.caches[f"l{i}"]["mamba"]).items():
            np.testing.assert_array_equal(
                v, tp_.flat(dense.caches[f"l{i}"]["mamba"])[k])
    for i in (5, 6, 7):          # after it: paged vs dense attention
        a = cache.caches[f"l{i}"]["mamba"]["ssm"]
        b = dense.caches[f"l{i}"]["mamba"]["ssm"]
        assert ((a - b).norm() / b.norm()).item() < 1e-2


def test_forward_fills_only_missing_mamba_layers(world):
    """A prefill handed a cache tree without some Mamba-2 layers starts
    them from zero and returns their states in the tree; a tree without
    the attention layer is refused (its prefill would write a fresh dense
    KV where the pools belong)."""
    cfg, tcfg, _, tp = world
    tok = {"tokens": torch.as_tensor(_tokens(cfg, 12, b=1))}
    full = tlm.init_caches(tcfg, 1, 16, device="cpu")
    with torch.no_grad():
        _, want = tlm.forward(tcfg, tp, tok, mode="prefill", caches=full)
        part = {k: v for k, v in tlm.init_caches(
            tcfg, 1, 16, device="cpu").items() if k != "l1"}
        _, got = tlm.forward(tcfg, tp, tok, mode="prefill", caches=part)
    assert sorted(got) == sorted(want)
    for k, v in tp_.flat(want).items():
        np.testing.assert_array_equal(tp_.flat(got)[k], v, err_msg=k)
    no_attn = {k: v for k, v in full.items() if k != "l4"}
    with pytest.raises(ValueError, match=r"lacks \['l4'\]"):
        tlm.forward(tcfg, tp, tok, mode="prefill", caches=no_attn)


def _serve(srv, prompts):
    return srv.serve([TReq(uid=i, prompt=p, sampling=TSP(max_tokens=12))
                      for i, p in enumerate(prompts)])


def test_paged_server_prefills_exact_length(world):
    """The paged server: ``_paged_kv`` and ``_has_ssm``; every admission
    runs the paged prefill step on the prompt's exact length; the memory
    report counts pages and per-slot SSM state, equal to the JAX
    package's ``PagedCache`` under the same admissions (``test_cache``'s
    hybrid case)."""
    cfg, tcfg, _, tp = world
    srv = teng.InferenceServer(tcfg, tp, device="cpu", cache="paged",
                               page_size=16, max_len=64, max_batch=2)
    assert srv._paged_kv and srv._has_ssm
    widths, inner = [], srv._prefill_paged

    def spy(params, batch, *rest):
        widths.append(batch["tokens"].shape[1])
        return inner(params, batch, *rest)

    srv._prefill_paged = spy
    prompts = [_tokens(cfg, s, b=1)[0] for s in (45, 12, 7)]
    _serve(srv, prompts)
    assert widths == [45, 12, 7]
    mem = srv.stats["memory"]
    assert mem["ssm_slot_bytes"] == tlm.ssm_bytes_per_slot(tcfg) > 0
    assert mem["peak_pages_in_use"] > 0
    j = jcache.PagedCache(cfg, 2, 64, page_size=16)
    t = tcache.PagedCache(tcfg, 2, 64, "cpu", page_size=16)
    reports = []
    for be in (j, t):
        h0, h1 = be.alloc(0, 0, 45), be.alloc(1, 1, 12)
        for _ in range(9):
            be.append(h0)
            be.append(h1)
        reports.append(be.memory_report())
    keys = ("pages_in_use", "peak_pages_in_use", "n_pages", "pages_free",
            "bytes_per_page", "ssm_slot_bytes", "cache_bytes_in_use",
            "peak_cache_bytes", "pool_bytes", "dense_equivalent_bytes")
    assert {k: reports[1][k] for k in keys} == \
        {k: reports[0][k] for k in keys}


def test_launcher_serves_jamba(capsys):
    """``launch/serve.py --arch jamba-1.5-large-398b-smoke --device cpu
    --plan demo --cache paged`` serves every request."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--arch", ARCH, "--plan", "demo",
                "--cache", "paged"])
    out = capsys.readouterr().out
    assert "58 groups" in out and "paged cache" in out
    assert "of SSM state a slot" in out
