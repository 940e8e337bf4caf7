"""The port's LM against the JAX package's on ``llama3.2-1b-smoke`` with
the same weights (``bridge.params_from_jax``): a prefill plus 8
teacher-forced decode steps, float and plan-bound, through the port's
dense and paged caches, against the JAX dense path (which the JAX
package's own tests hold bitwise equal to its paged path)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro.configs import registry
from repro.models import lm as jlm
from repro.serve import engine as jeng
from repro_torch.bridge import params_from_jax
from repro_torch.launch import steps
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as teng
from torch_threads import _one_torch_thread  # noqa: F401

S0, N_DEC, MAX_LEN, PS = 13, 8, 32, 8


@pytest.fixture(scope="module")
def models():
    cfg = registry.get("llama3.2-1b-smoke")
    jp = jlm.init_params(cfg, jax.random.key(0))
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _jax_logits(cfg, params, tokens):
    """Prefill + teacher-forced decode through the JAX dense path."""
    prefill = jax.jit(lambda p, t: jlm.forward(
        cfg, p, {"tokens": t}, mode="prefill", logits_mode="last"))
    decode = jax.jit(lambda p, t, c, pos: jlm.decode_step(
        cfg, p, {"tokens": t}, c, pos))
    logits, pc = prefill(params, jnp.asarray(tokens[:, :S0]))
    caches = jlm.init_caches(cfg, 1, MAX_LEN)
    caches = jax.tree.map(lambda big, small: big.at[:, :, :S0].set(small),
                          caches, pc)
    out = [np.asarray(logits[:, -1].astype(jnp.float32))]
    for i in range(N_DEC):
        logits, caches = decode(params, jnp.asarray(tokens[:, S0 + i:
                                                           S0 + i + 1]),
                                caches, jnp.asarray([S0 + i], jnp.int32))
        out.append(np.asarray(logits[:, -1].astype(jnp.float32)))
    return np.stack(out)


def _torch_logits(cfg, params, tokens, cache):
    tok = torch.as_tensor(tokens)
    if cache == "dense":
        logits, pc = steps.make_prefill_step(cfg)(params,
                                                  {"tokens": tok[:, :S0]})
        caches = tlm.init_caches(cfg, 1, MAX_LEN, device="cpu")
        for ln, c in caches.items():
            for k, big in c["kv"].items():
                big[:, :, :S0] = pc[ln]["kv"][k]
        tables = None
    else:
        caches = tlm.init_paged_caches(cfg, 1, PS, MAX_LEN // PS, "cpu")
        tables = torch.arange(1, MAX_LEN // PS + 1,
                              dtype=torch.int32)[None]
        spad = -(-S0 // PS) * PS
        padded = torch.zeros((1, spad), dtype=tok.dtype)
        padded[:, :S0] = tok[:, :S0]
        logits, caches = steps.make_paged_prefill_step(cfg)(
            params, {"tokens": padded}, caches, tables[:, :spad // PS],
            torch.tensor([S0], dtype=torch.int32))
    decode = steps.make_decode_step(cfg)
    out = [logits[:, -1].float().numpy()]
    for i in range(N_DEC):
        logits, caches = decode(params, {"tokens": tok[:, S0 + i:S0 + i + 1]},
                                caches,
                                torch.tensor([S0 + i], dtype=torch.int32),
                                tables)
        out.append(logits[:, -1].float().numpy())
    return np.stack(out)


@pytest.mark.parametrize("plan_kind", ["float", "mixed", "w4"])
def test_teacher_forced_logits_match_jax(models, plan_kind):
    """Logits agree within ``2e-2 * max|logits|``: the compute is bf16
    (8 significant bits), and the per-row int8 activation quantization of
    a planned projection can turn a one-ulp bf16 difference into one
    integer step.  Measured max |diff| / max |logits| on this case: float
    6.0e-3, mixed 1.6e-2, w4 7.8e-3; plan-bound steps whose inputs agree
    bitwise give exactly 0."""
    cfg, jp, tp = models
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(1, S0 + N_DEC)).astype(np.int32)
    if plan_kind == "float":
        jparams, tparams = jp, tp
    else:
        bits = None if plan_kind == "mixed" else 4
        jplan = jeng.synthetic_plan(cfg, jp, bits=bits, seed=0)
        tplan = teng.synthetic_plan(cfg, tp, bits=bits, seed=0)
        assert all(np.array_equal(jplan.channel_bits[g],
                                  tplan.channel_bits[g])
                   for g in jplan.groups) and jplan.groups == tplan.groups
        jparams = jeng.apply_plan(cfg, jp, jplan)
        tparams = teng.apply_plan(cfg, tp, tplan)
    want = _jax_logits(cfg, jparams, tokens)
    tol = 2e-2 * np.abs(want).max()
    outs = {c: _torch_logits(cfg, tparams, tokens, c)
            for c in ("dense", "paged")}
    for cache, got in outs.items():
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=f"{plan_kind}/{cache}")
    # within the port, dense and paged are bitwise equal
    np.testing.assert_array_equal(outs["dense"], outs["paged"])


@pytest.fixture(scope="module")
def one_layer():
    """``llama3.2-1b-smoke`` cut to one layer, the JAX package's key-0
    weights, and its jitted hidden-state prefill."""
    import dataclasses
    from repro.nn import blocks as jblocks
    from repro_torch.configs import registry as treg
    jcfg = dataclasses.replace(registry.get("llama3.2-1b-smoke"), n_layers=1)
    tcfg = dataclasses.replace(treg.get("llama3.2-1b-smoke"), n_layers=1)
    jp = jlm.init_params(jcfg, jax.random.key(0))
    prefill = jax.jit(lambda p, t: jlm.forward(
        jcfg, p, {"tokens": t}, mode="prefill", logits_mode="hidden")[0])
    attn = jax.jit(lambda q, k, v: jblocks.flash_attention(q, k, v))
    return tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp)), \
        prefill, attn


@pytest.mark.parametrize("seed", [0, 2, 3])
def test_100_token_prefill_gap_is_the_attention_arithmetic(one_layer, seed,
                                                           monkeypatch):
    """A 100-token one-layer prefill differs from the JAX package's in the
    hidden values of at most one token position, within 1e-2 relative L2
    of that row (measured: seed 0 37 values of position 58, 5.3e-3; seed 2
    51 of position 85, 8.6e-3; seed 3 2 of position 19, 7.7e-4; seeds 1,
    4, 5 none).  The cause is the float32 attention's arithmetic alone:
    with the JAX package's own ``flash_attention`` in the port's place the
    hidden states are bitwise.  XLA's CPU sums those einsums in Eigen's
    blocked orders, which change with the shape (ROADMAP section 3), so
    the port does not mirror them."""
    from repro_torch.nn import blocks as tblocks
    tcfg, jp, tp, prefill, attn = one_layer
    toks = np.random.default_rng(seed).integers(
        0, tcfg.vocab, size=(1, 100)).astype(np.int32)
    want = np.asarray(prefill(jp, toks).astype(jnp.float32))[0]

    def port():
        with torch.no_grad():
            h, _ = tlm.forward(tcfg, tp, {"tokens": torch.as_tensor(toks)},
                               mode="prefill", logits_mode="hidden")
        return h.float().numpy()[0]

    got = port()
    rows = np.nonzero((got != want).any(-1))[0]
    assert len(rows) <= 1, rows
    for r in rows:
        rel = np.linalg.norm(got[r] - want[r]) / np.linalg.norm(want[r])
        assert rel <= 1e-2, (r, rel)

    def jax_attention(q, k, v, **kw):
        assert kw.get("causal", True) and not kw.get("window") and \
            not kw.get("cap")
        out = attn(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                     for t in (q, k, v)))
        return torch.tensor(np.asarray(out.astype(jnp.float32))).to(
            q.dtype)

    monkeypatch.setattr(tblocks, "flash_attention", jax_attention)
    np.testing.assert_array_equal(port(), want)


def test_128_token_residual_is_the_rope_table(one_layer, monkeypatch):
    """At 128 tokens seed 2 still differs in 69 hidden values with the
    JAX package's ``flash_attention`` in the port's place.  The first op
    at which the hidden states part is RoPE: the K projection is bitwise
    and two of its roped values are not.  Under ``jax.jit`` the prefill's
    positions are a constant, so XLA folds the whole table, ``theta **
    (i / half)``, ``cos`` and ``sin``, at compile time with its own
    float32 functions, which round otherwise than torch's.  With the JAX
    package's ``rope`` too the hidden states are bitwise (ROADMAP section
    3: an XLA arithmetic the port does not mirror; the bound stays)."""
    from repro.nn import blocks as jblocks
    from repro_torch.nn import blocks as tblocks
    tcfg, jp, tp, prefill, attn = one_layer
    s = 128
    toks = np.random.default_rng(2).integers(
        0, tcfg.vocab, size=(1, s)).astype(np.int32)
    want = np.asarray(prefill(jp, toks).astype(jnp.float32))[0]
    folded = jax.jit(lambda x: jblocks.rope(x, jnp.arange(s),
                                            tcfg.rope_theta))

    def via_jax(fn, *ts):
        out = fn(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                   for t in ts))
        return torch.tensor(np.asarray(out.astype(jnp.float32))).to(
            ts[0].dtype)

    def port():
        with torch.no_grad():
            h, _ = tlm.forward(tcfg, tp, {"tokens": torch.as_tensor(toks)},
                               mode="prefill", logits_mode="hidden")
        return h.float().numpy()[0]

    monkeypatch.setattr(tblocks, "flash_attention",
                        lambda q, k, v, **kw: via_jax(attn, q, k, v))
    assert (port() != want).sum() == 69
    monkeypatch.setattr(tblocks, "rope", lambda x, pos, theta: via_jax(
        folded, x) if torch.equal(pos, torch.arange(s)) else None)
    np.testing.assert_array_equal(port(), want)
