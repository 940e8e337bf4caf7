"""The port's VLM (``qwen2-vl-72b-smoke``: the dense decoder fed the
vision frontend stub's patch embeddings) against the JAX package on the
CPU, with the reference's parameters carried across
(``bridge.lm_params_from_jax``), numpy-seeded inputs and the JAX side
under ``jax.jit``.

Held identical: the ``init_params(mps_on=True)`` tree and its gammas,
``mps_param_count``, ``extract_plan``'s group names and bits and every
greedy token id; inside the port, dense and paged prefill + decode are
bitwise equal.  Float results, within the bounds of
``tests/test_torch_lm.py`` and ``tests/test_torch_train.py``: logits
within ``2e-2 * max|logits|``, losses rtol 1e-4, per-leaf gradients
within 3e-2 relative L2, ``mps_size_cost`` rtol 1e-6, three
``make_train_step`` steps' updates within ``6 * lr`` and within relative
L2 0.15 over each leaf (measured values in each test's docstring).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro.configs import registry as jreg
from repro.core import mps as jmps
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro.serve import engine as jeng
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import registry as treg
from repro_torch.core import mps as tmps
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.optim import grad as tgrad
from repro_torch.optim import optimizers as topt
from repro_torch.serve import engine as teng

import torch_parity as tp_
from torch_threads import _one_torch_thread  # noqa: F401

ARCH = "qwen2-vl-72b-smoke"
B, S = 2, 64
LAM = 1e-6


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = jreg.get(ARCH), treg.get(ARCH)
    jp = jlm.init_params(jcfg, jax.random.key(0), mps_on=True)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg=tcfg)
    return jcfg, tcfg, jp, tp


def _embeddings(cfg, b, s, seed):
    """Patch embeddings as the frontend stub hands them over: bf16."""
    emb = 0.1 * np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model))
    return np.asarray(jnp.asarray(emb, jnp.bfloat16))


def _batch(cfg, form, seed=0):
    """``tests/test_lm_archs.py``'s batch forms: tokens, or the
    frontend's embeddings with targets."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    out = {"targets": toks[:, 1:]}
    if form == "tokens":
        out["tokens"] = toks[:, :-1]
    else:
        out["embeddings"] = _embeddings(cfg, B, S, seed + 1)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: tp_.to_torch(v) for k, v in batch.items()})


def test_init_params_tree_and_counts_match_jax(world):
    jcfg, tcfg, jp, _ = world
    want = tp_.flat(jp)
    got = tp_.flat(tlm.init_params(tcfg, device="cpu", mps_on=True))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if k.endswith("gamma"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert tlm.mps_param_count(tcfg) == jlm.mps_param_count(jcfg) == 7
    assert tlm.kv_bytes_per_token(tcfg) == jlm.kv_bytes_per_token(jcfg)
    assert tlm.dense_cache_bytes(tcfg, 3, 40) == \
        jlm.dense_cache_bytes(jcfg, 3, 40)


@pytest.mark.parametrize("form", ["tokens", "embeddings"])
def test_train_forward_logits_match_jax(world, form):
    """Measured max |diff| / max |logits|: tokens 8.5e-3, embeddings 0."""
    jcfg, tcfg, jp, tp = world
    jb, tb = _both(_batch(jcfg, form))
    want = np.asarray(jax.jit(lambda p, b: jlm.forward(
        jcfg, p, b, mode="train")[0])(jp, jb).astype(jnp.float32))
    with torch.no_grad():
        got = tlm.forward(tcfg, tp, tb, mode="train")[0].float().numpy()
    assert got.shape == want.shape == (B, S, tlm.padded_vocab(tcfg))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_loss_grads_and_size_cost_match_jax(world):
    """Under a ``SearchCtx`` with ``lam`` > 0, from patch embeddings.
    Measured: loss 2.9e-6 relative, size cost 2.7e-7, gradients at most
    8.0e-3 (``wk``)."""
    jcfg, tcfg, jp, tp = world
    jctx, tctx = jmps.SearchCtx(tau=1.0), tmps.SearchCtx(tau=1.0)
    jb, tb = _both(_batch(jcfg, "embeddings", seed=1))
    (jl, jc), jg = jax.jit(jax.value_and_grad(
        lambda p, b: (jlm.loss_fn(jcfg, p, b, ctx=jctx, lam=LAM),
                      jlm.mps_size_cost(jcfg, p, jctx)),
        has_aux=True))(jp, jb)
    tl, tg = tgrad.value_and_grad(
        lambda p, b: tlm.loss_fn(tcfg, p, b, ctx=tctx, lam=LAM), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(tlm.mps_size_cost(tcfg, tp, tctx)),
                               float(jc), rtol=1e-6)
    want, got = tp_.flat(jg), tp_.flat(tg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tp_.rel(got[k], v) < 3e-2, (k, tp_.rel(got[k], v))


def test_make_train_step_matches_jax(world):
    """Three steps, as the dense family's test takes: losses rtol 2e-4,
    each update within 6 lr of the reference's and within relative L2
    0.15 over each leaf (measured 2.7 lr and 0.089; after one step a
    gamma's update reaches 0.17, Adam moving an entry whose gradient is
    near 0 by about lr either way)."""
    jcfg, tcfg, jp, tp = world
    lr = 3e-4
    jo, to = jopt.make_optimizer("adam", lr), topt.make_optimizer("adam", lr)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jo, search=True))
    tstep = tsteps.make_train_step(tcfg, to, search=True)
    js, ts = jo.init(jp), to.init(tp)
    start = tp_.flat(jp)
    for step in range(3):
        jb, tb = _both(_batch(jcfg, "embeddings", seed=3 + step))
        jp, js, jl = jstep(jp, js, jb, jnp.asarray(step))
        tp, ts, tl = tstep(tp, ts, tb, step)
        np.testing.assert_allclose(float(tl), float(jl), rtol=2e-4)
    want, got = tp_.flat(jp), tp_.flat(tp)
    for k, v in want.items():
        assert np.abs(got[k] - v).max() <= 6 * lr, k
        rel = tp_.rel(got[k] - start[k], v - start[k])
        assert rel < 0.15, (k, rel)


def test_extract_plan_matches_jax(world):
    jcfg, tcfg, jp, _ = world
    rng = np.random.default_rng(4)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: rng.normal(size=x.shape).astype(np.float32)
        if path[-1].key == "gamma" else x, jp)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg=tcfg)
    want, got = jlm.extract_plan(jcfg, jp), tlm.extract_plan(tcfg, tp)
    assert got.groups == want.groups and len(got.groups) == 14
    for grp in want.groups:
        np.testing.assert_array_equal(got.channel_bits[grp],
                                      want.channel_bits[grp])
    assert got.meta == want.meta


N_NEW, S0, MAX_LEN = 9, 21, 48


@pytest.mark.parametrize("bound", ["float", "plan"])
def test_prefill_from_embeddings_and_greedy_decode_match_jax(world, bound):
    """A prefill from patch embeddings, dense and paged (padded to a page
    boundary), then greedy decode from the generated tokens: token ids
    identical to the JAX package's dense path, logits within the bound
    (measured max |diff| / max |logits|: float 0, plan 0), and the port's
    dense and paged streams bitwise equal."""
    jcfg, tcfg, jp, tp = world
    if bound == "plan":
        jplan, tplan = tp_.quarter_plans(jcfg, jp)
        jp, tp = jeng.apply_plan(jcfg, jp, jplan), \
            teng.apply_plan(tcfg, tp, tplan)
    batch = {"embeddings": _embeddings(jcfg, B, S0, 5)}
    want_t, want_l, _ = tp_.jax_greedy(jcfg, jp, batch, N_NEW, MAX_LEN)
    got = {c: tp_.port_greedy(tcfg, tp, batch, N_NEW, MAX_LEN, cache=c)
           for c in ("dense", "paged")}
    for c, (got_t, got_l, _) in got.items():
        np.testing.assert_array_equal(got_t, want_t, err_msg=c)
        np.testing.assert_allclose(got_l, want_l, rtol=0,
                                   atol=2e-2 * np.abs(want_l).max(),
                                   err_msg=c)
    np.testing.assert_array_equal(got["dense"][0], got["paged"][0])
    np.testing.assert_array_equal(got["dense"][1], got["paged"][1])


def test_the_server_refuses_it(world):
    _, tcfg, _, tp = world
    with pytest.raises(NotImplementedError,
                       match="decoder-only token-frontend architectures; got "
                             "qwen2-vl-72b-smoke \\(family=vlm, "
                             "frontend=vision\\)"):
        teng.InferenceServer(tcfg, tp, max_len=16, max_batch=1,
                             device="cpu")
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="decoder-only"):
        serve.main(["--device", "cpu", "--arch", ARCH, "--plan", "demo"])
