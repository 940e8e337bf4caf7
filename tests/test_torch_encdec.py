"""The port's encoder-decoder (``seamless-m4t-medium-smoke``: a 1-layer
bidirectional encoder, 2 decoder layers with cross attention, the audio
frontend stub's embeddings) against the JAX package on the CPU, with the
reference's parameters carried across (``bridge.lm_params_from_jax``),
numpy-seeded inputs and the JAX side under ``jax.jit``.

Held identical: the ``init_params(mps_on=True)`` tree and its gammas,
``mps_param_count``, ``extract_plan``'s group names and bits, the cache
byte counts and every greedy token id.  Float results, within these
stated tolerances, and why:

* ``forward(mode="train")`` logits and the greedy streams' logits:
  within ``2e-2 * max|logits|``, the bound of ``tests/test_torch_lm.py``
  (bf16 compute, f32 matmuls summed in another order after the float
  cross attention; measured in the docstrings below);
* losses rtol 1e-4 and per-leaf gradients within 3e-2 relative L2, the
  dense family's bounds in ``tests/test_torch_train.py``;
  ``mps_size_cost`` rtol 1e-6; three ``make_train_step`` steps: losses
  rtol 2e-4, every update within ``6 * lr`` of the reference's and
  within relative L2 0.15 over each leaf;
* the prefill's ``cross_kv``: within 1e-5 relative L2 float (the f32
  projections of a bf16 encoder output), bitwise plan-bound.

The cross attention takes the raw weights, as the reference's does (its
``_layer_apply`` passes the cross branch no weight hook): under the
search its projections use the f32 masters, not K4's effective weight,
and its gammas learn from the size cost alone; in a float tree its f32
products promote the rest of the layer to f32 (ROADMAP section 3).
"""
import os
import subprocess
import sys

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "seamless-m4t-medium-smoke"
B, S, S_ENC = 2, 64, 32
LAM = 1e-6


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = jreg.get(ARCH), treg.get(ARCH)
    jp = jlm.init_params(jcfg, jax.random.key(0), mps_on=True)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg=tcfg)
    return jcfg, tcfg, jp, tp


def _batch(cfg, form, seed=0):
    """The batch forms ``tests/test_lm_archs.py``'s ``_batch`` builds,
    from numpy: ``tokens`` (+ an encoder of its own length 32), the
    frontend's ``embeddings`` (the encoder embeds them too), the two
    with ``enc_embeddings`` beside them (the reference's smoke batch),
    and tokens alone (the encoder embeds the tokens)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    emb = (0.1 * rng.standard_normal((B, S, cfg.d_model))).astype(
        np.float32)
    enc = (0.1 * rng.standard_normal((B, S_ENC, cfg.d_model))).astype(
        np.float32)
    out = {"targets": toks[:, 1:]}
    if form in ("tokens", "tokens_only", "embeddings+enc"):
        out["tokens"] = toks[:, :-1]
    if form in ("embeddings", "embeddings+enc"):
        out["embeddings"] = np.asarray(jnp.asarray(emb, jnp.bfloat16))
    if form in ("tokens", "embeddings+enc"):
        out["enc_embeddings"] = enc
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: tp_.to_torch(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

def test_init_params_tree_and_counts_match_jax(world):
    jcfg, tcfg, jp, _ = world
    want = tp_.flat(jp)
    got = tp_.flat(tlm.init_params(tcfg, device="cpu", mps_on=True))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if k.endswith("gamma"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the encoder is stacked on its own super-block count (1 against the
    # decoder's 2 at smoke size)
    assert got["enc_blocks/l0/mixer/wq/w"].shape[0] == 1
    assert got["blocks/l0/cross/wq/gamma"].shape[0] == 2
    assert tlm.mps_param_count(tcfg) == jlm.mps_param_count(jcfg) == 18
    assert tlm.enc_pattern(tcfg)[0].mixer == "attn_bidir"
    assert tlm.block_pattern(tcfg)[0].cross
    for b, s in ((1, 1), (3, 40)):
        assert tlm.dense_cache_bytes(tcfg, b, s) == \
            jlm.dense_cache_bytes(jcfg, b, s)
    assert tlm.kv_bytes_per_token(tcfg) == jlm.kv_bytes_per_token(jcfg)
    assert tlm.ssm_bytes_per_slot(tcfg) == jlm.ssm_bytes_per_slot(jcfg) == 0


def test_bridge_checks_the_encoder_stack(world):
    _, tcfg, jp, _ = world
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, enc_blocks=jax.tree.map(
        lambda a: np.concatenate([a, a]), tree["enc_blocks"]))
    with pytest.raises(ValueError, match="enc_blocks: 2 super-blocks"):
        lm_params_from_jax(bad, cfg=tcfg)
    bad = jax.tree.map(lambda x: x, tree)
    bad["enc_blocks"]["l0"]["ffn"]["w_up"]["gamma"] = \
        tree["enc_blocks"]["l0"]["ffn"]["w_up"]["gamma"][:, :3]
    with pytest.raises(ValueError, match="enc_blocks.l0.ffn.w_up.gamma"):
        lm_params_from_jax(bad, cfg=tcfg)
    bad = {k: v for k, v in tree.items() if k != "enc_norm"}
    with pytest.raises(ValueError, match="enc_norm"):
        lm_params_from_jax(bad, cfg=tcfg)


# ---------------------------------------------------------------------------
# forward, loss, gradients, a train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["tokens", "embeddings", "embeddings+enc",
                                  "tokens_only"])
def test_train_forward_logits_match_jax(world, form):
    """Float tree (f32 masters), every batch form.  Measured max |diff| /
    max |logits|: tokens 6.2e-3, embeddings 5.7e-3, embeddings+enc
    8.5e-3, tokens only 7.3e-3."""
    jcfg, tcfg, jp, tp = world
    jb, tb = _both(_batch(jcfg, form))
    want = np.asarray(jax.jit(lambda p, b: jlm.forward(
        jcfg, p, b, mode="train")[0])(jp, jb).astype(jnp.float32))
    with torch.no_grad():
        got = tlm.forward(tcfg, tp, tb, mode="train")[0].float().numpy()
    assert got.shape == want.shape == (B, S, tlm.padded_vocab(tcfg))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_loss_and_grads_match_jax(world):
    """Under a ``SearchCtx`` with ``lam`` > 0, on the reference's smoke
    batch (frontend embeddings, encoder frames of 32 against 64 decoder
    positions): every leaf's gradient, the cross gammas' included, which
    are the size cost's alone (the cross branch bypasses the weight
    hook).  Measured: loss 7.4e-6 relative; gradients at most 9.6e-3
    (the encoder's ``wk``), the cross gammas' 9.6e-8."""
    jcfg, tcfg, jp, tp = world
    jctx, tctx = jmps.SearchCtx(tau=1.0), tmps.SearchCtx(tau=1.0)
    jb, tb = _both(_batch(jcfg, "embeddings+enc", seed=1))
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b, ctx=jctx, lam=LAM)))(jp, jb)
    tl, tg = tgrad.value_and_grad(
        lambda p, b: tlm.loss_fn(tcfg, p, b, ctx=tctx, lam=LAM), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    want, got = tp_.flat(jg), tp_.flat(tg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tp_.rel(got[k], v) < 3e-2, (k, tp_.rel(got[k], v))
        if k.endswith("gamma"):
            assert (np.abs(got[k]).sum(axis=(1, 2)) > 0).all(), k
    _, size_only = tgrad.value_and_grad(
        lambda p, _: LAM * tlm.mps_size_cost(tcfg, p, tctx), tp, None)
    size_only = tp_.flat(size_only)
    for k in got:
        if "/cross/" in k and k.endswith("gamma"):
            np.testing.assert_allclose(got[k], size_only[k], rtol=1e-6,
                                       err_msg=k)


def test_mps_size_cost_matches_jax(world):
    jcfg, tcfg, jp, _ = world
    rng = np.random.default_rng(2)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: rng.normal(size=x.shape).astype(np.float32)
        if path[-1].key == "gamma" else x, jp)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg=tcfg)
    want = jax.jit(lambda p: jlm.mps_size_cost(jcfg, p,
                                               jmps.SearchCtx(tau=1.0)))(jp)
    got = tlm.mps_size_cost(tcfg, tp, tmps.SearchCtx(tau=1.0))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_make_train_step_matches_jax(world):
    """Three steps, as the dense family's test takes: losses rtol 2e-4,
    each update within 6 lr of the reference's and within relative L2
    0.15 over each leaf (measured 2.5 lr and 0.096; after one step a
    norm's update reaches 0.17, Adam moving an entry whose gradient is
    near 0 by about lr either way); every gamma moves, the cross
    attention's too."""
    jcfg, tcfg, jp, tp = world
    lr = 3e-4
    jo, to = jopt.make_optimizer("adam", lr), topt.make_optimizer("adam", lr)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jo, search=True))
    tstep = tsteps.make_train_step(tcfg, to, search=True)
    js, ts = jo.init(jp), to.init(tp)
    start = tp_.flat(jp)
    for step in range(3):
        jb, tb = _both(_batch(jcfg, "embeddings+enc", seed=3 + step))
        jp, js, jl = jstep(jp, js, jb, jnp.asarray(step))
        tp, ts, tl = tstep(tp, ts, tb, step)
        np.testing.assert_allclose(float(tl), float(jl), rtol=2e-4)
    want, got = tp_.flat(jp), tp_.flat(tp)
    for k, v in want.items():
        assert np.abs(got[k] - v).max() <= 6 * lr, k
        rel = tp_.rel(got[k] - start[k], v - start[k])
        assert rel < 0.15, (k, rel)
    assert all(not np.array_equal(got[k], start[k])
               for k in want if k.endswith("gamma")), "a gamma idled"


def test_extract_plan_matches_jax(world):
    """132 groups at full width; here 2 super-blocks x 11 (self
    attention, cross attention, FFN); the encoder is no plan group."""
    jcfg, tcfg, jp, _ = world
    rng = np.random.default_rng(4)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: rng.normal(size=x.shape).astype(np.float32)
        if path[-1].key == "gamma" else x, jp)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg=tcfg)
    want, got = jlm.extract_plan(jcfg, jp), tlm.extract_plan(tcfg, tp)
    assert got.groups == want.groups and len(got.groups) == 22
    assert "blocks.l0.cross.wq.sb1" in got.groups
    assert not any(g.startswith("enc_blocks") for g in got.groups)
    for grp in want.groups:
        np.testing.assert_array_equal(got.channel_bits[grp],
                                      want.channel_bits[grp])
        np.testing.assert_array_equal(got.permutations[grp],
                                      want.permutations[grp])
    assert got.meta == want.meta


# ---------------------------------------------------------------------------
# prefill, greedy decode, plan-bound
# ---------------------------------------------------------------------------

N_NEW, S0, MAX_LEN = 9, 21, 48


@pytest.fixture(scope="module")
def plans(world):
    jcfg, tcfg, jp, tp = world
    jplan, tplan = tp_.quarter_plans(jcfg, jp)
    assert tplan.groups == tuple(sorted(tlm.serve_weight_groups(tcfg, tp)))
    assert len(tplan.groups) == 22
    return jeng.apply_plan(jcfg, jp, jplan), teng.apply_plan(tcfg, tp, tplan)


@pytest.mark.parametrize("bound", ["float", "plan"])
def test_prefill_and_greedy_decode_match_jax(world, plans, bound):
    """A dense prefill (its ``cross_kv`` compared), then 8 greedy decode
    steps through ``init_caches(max_len, enc_len)``.  The port's decode
    skips the encoder (the reference runs it over the step's one token
    and reads none of it): the logits agree all the same.  Measured max
    |diff| / max |logits|: float 6.1e-3 (``cross_kv`` 1.6e-7 relative
    L2), plan-bound 0 (caches bitwise too).
    The plan-bound tree binds the cross projections (K1) and keeps the
    encoder stacked and float."""
    jcfg, tcfg, jp, tp = world
    if bound == "plan":
        jp, tp = plans
        assert isinstance(tp["blocks"], tuple) and \
            not isinstance(tp["enc_blocks"], tuple)
        assert type(tp["blocks"][0]["l0"]["cross"]["wk"]["w"]).__name__ \
            == "PackedLinear"
    batch = _batch(jcfg, "tokens", seed=5)
    batch = {"tokens": batch["tokens"][:, :S0],
             "enc_embeddings": batch["enc_embeddings"]}
    want_t, want_l, want_c = tp_.jax_greedy(jcfg, jp, batch, N_NEW, MAX_LEN,
                                            enc_len=S_ENC)
    got_t, got_l, got_c = tp_.port_greedy(tcfg, tp, batch, N_NEW, MAX_LEN,
                                          enc_len=S_ENC)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_l, want_l, rtol=0,
                               atol=2e-2 * np.abs(want_l).max())
    wc, gc = tp_.flat(want_c), tp_.flat(got_c)
    assert sorted(wc) == sorted(gc) == ["l0/cross_kv/k", "l0/cross_kv/v",
                                         "l0/kv/k", "l0/kv/v"]
    for k in ("l0/cross_kv/k", "l0/cross_kv/v"):
        assert gc[k].shape == (2, B, S_ENC, tcfg.hkv_eff, tcfg.head_dim)
        assert got_c["l0"]["cross_kv"]["k"].dtype == (
            torch.float32 if bound == "float" else torch.bfloat16)
        if bound == "plan":
            np.testing.assert_array_equal(gc[k], wc[k], err_msg=k)
        else:
            assert tp_.rel(gc[k], wc[k]) < 1e-5, (k, tp_.rel(gc[k], wc[k]))


def test_decode_with_zero_cross_cache_matches_jax(world):
    """``TestArchSmoke.test_decode_step_runs``' case: zero caches with a
    cross length of 32, a frontend embedding at position 5 (measured max
    |diff| / max |logits| 8.7e-3)."""
    jcfg, tcfg, jp, tp = world
    emb = np.full((2, 1, jcfg.d_model), 0.1, np.float32)
    want, _ = jax.jit(lambda p, e: jlm.decode_step(
        jcfg, p, {"embeddings": e.astype(jnp.bfloat16)},
        jlm.init_caches(jcfg, 2, 64, enc_len=32), jnp.asarray(5)))(jp, emb)
    with torch.no_grad():
        got, caches = tlm.decode_step(
            tcfg, tp, {"embeddings": torch.as_tensor(emb).to(torch.bfloat16)},
            tlm.init_caches(tcfg, 2, 64, enc_len=32, device="cpu"),
            torch.tensor(5))
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape[:2] == (2, 1) and np.isfinite(want).all()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())
    assert not caches["l0"]["cross_kv"]["k"].any()


def test_paged_caches_and_the_server_refuse_it(world):
    _, tcfg, _, tp = world
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tlm.init_paged_caches(tcfg, 1, 8, 4, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="decoder-only token-frontend architectures; got "
                             "seamless-m4t-medium-smoke \\(family=encdec, "
                             "frontend=audio\\)"):
        teng.InferenceServer(tcfg, tp, max_len=16, max_batch=1,
                             device="cpu")
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="decoder-only"):
        serve.main(["--device", "cpu", "--arch", ARCH, "--plan", "demo"])


def test_train_launcher_on_seamless():
    """``launch/train.py`` trains on tokens alone, as the reference's
    launcher does (the encoder embeds them), and prints the plan."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", ARCH, "--search", "--steps", "2", "--seq", "16"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert res.returncode == 0, res.stderr
    assert "[train] step 1 loss" in res.stdout
    assert "CompressionPlan(22 groups" in res.stdout, res.stdout
