"""The port's LM training and the paper's joint search on the LM track
(``repro_torch`` data/, optim/, models/lm, launch/steps, launch/train)
against the JAX package on the CPU, with the reference's parameters
carried across (``bridge.lm_params_from_jax``) and the JAX side under
``jax.jit``, as its training step runs.

Integer artifacts are held identical: ``lm_batch``'s tokens, int8 EF
codes and their scales, ``adam_int8``'s int8 moments, the
``init_params(mps_on=True)`` tree with its gammas, ``mps_param_count``
and ``extract_plan``'s group names and bits.  Float results, within
these stated tolerances, and why:

* ``global_norm`` / clipping / the EF residual and ``mps_size_cost``:
  rtol 1e-6 (float32 sums in another order; measured 2.7e-7 for the
  size cost);
* ``adam_int8``'s row scales rtol 1e-6, its parameters rtol 1e-5 (XLA
  contracts the update's ``a * b + c`` steps into FMAs; measured
  1.2e-6);
* losses: rtol 1e-4 (bf16 compute; XLA fuses the bf16 elementwise ops
  of the softcaps and the residual stream without rounding, the port
  rounds some; measured at most 1.1e-5, gemma2 with both softcaps);
* gradients: relative L2 per leaf within 3e-2 (measured at most 1.0e-2:
  the embedding's gradient is summed in f32 here and in bf16 by the
  reference, and bf16 products feed every other);
* three ``make_train_step`` steps (Adam at lr 3e-4): losses rtol 2e-4
  (measured 6.0e-5 at the second step); each parameter's update within
  ``6 * lr`` of the reference's and within relative L2 0.15 over each
  leaf (measured 4.4 lr and 0.096): Adam's first steps move an entry by
  about ``lr`` whatever its gradient's size, so an entry whose gradient
  is near zero may step the other way in one package.
"""
import dataclasses
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro.configs import registry as jreg
from repro.core import mps as jmps
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import grad as jgrad
from repro.optim import optimizers as jopt
from repro_torch.bridge import lm_params_from_jax, tree_to_numpy
from repro_torch.configs import registry as treg
from repro_torch.core import mps as tmps
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.optim import grad as tgrad
from repro_torch.optim import optimizers as topt
from repro_torch.serve import engine as teng
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Request
from torch_threads import _one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA = "llama3.2-1b-smoke"


def _flat(tree, prefix=""):
    """``{"a/b": numpy}`` of a JAX or port tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if torch.is_tensor(tree):
        return {prefix[:-1]: tree.detach().numpy()}
    return {prefix[:-1]: np.asarray(tree)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batch(cfg, step, batch=2, seq=33):
    jb = jsyn.lm_batch(cfg.vocab, seq, batch, step)
    return jb, {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}


@pytest.fixture(scope="module")
def llama():
    jcfg, tcfg = jreg.get(LLAMA), treg.get(LLAMA)
    jp = jlm.init_params(jcfg, jax.random.key(0), mps_on=True)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg=tcfg)
    return jcfg, tcfg, jp, tp


# ---------------------------------------------------------------------------
# data, gradient utilities, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab", [512, 128256])
def test_lm_batch_matches_jax(vocab):
    for step in (0, 1, 7):
        for seed in (0, 3):
            want = jsyn.lm_batch(vocab, 33, 4, step, seed)
            got = tsyn.lm_batch(vocab, 33, 4, step, seed)
            for k in ("tokens", "targets"):
                assert got[k].dtype == torch.int32
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))


def _grad_tree(rng, scale=1.0):
    return {"w": rng.normal(size=(6, 5)).astype(np.float32) * scale,
            "b": {"v": rng.normal(size=(7,)).astype(np.float32) * scale,
                  "s": np.float32(rng.normal() * scale)}}


def test_grad_utils_match_jax():
    rng = np.random.default_rng(0)
    g = _grad_tree(rng, 3.0)
    tg = tgrad.tree_map(torch.as_tensor, g)
    np.testing.assert_allclose(float(tgrad.global_norm(tg)),
                               float(jax.jit(jgrad.global_norm)(g)),
                               rtol=1e-6)
    for max_norm in (1.0, 1e3):
        want, wn = jax.jit(jgrad.clip_by_global_norm,
                           static_argnums=1)(g, max_norm)
        got, gn = tgrad.clip_by_global_norm(tg, max_norm)
        np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
        for k, v in _flat(want).items():
            np.testing.assert_allclose(_flat(got)[k], v, rtol=1e-6)
    # error feedback over three steps: codes and scales equal, and the
    # residual carried from step to step
    jerr, terr = jgrad.init_error_tree(g), tgrad.init_error_tree(tg)
    ef = jax.jit(jgrad.ef_compress_tree)
    for step in range(3):
        g = _grad_tree(rng)
        tg = tgrad.tree_map(torch.as_tensor, g)
        jcomp, jerr = ef(g, jerr)
        tcomp, terr = tgrad.ef_compress_tree(tg, terr)
        for path in (("w",), ("b", "v"), ("b", "s")):
            jq, js = jcomp[path[0]] if len(path) == 1 else \
                jcomp[path[0]][path[1]]
            tq, ts = tcomp[path[0]] if len(path) == 1 else \
                tcomp[path[0]][path[1]]
            assert tq.dtype == torch.int8
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        for k, v in _flat(jerr).items():
            np.testing.assert_allclose(_flat(terr)[k], v, rtol=1e-6,
                                       atol=1e-7)
        dq = tgrad.ef_decompress_tree(tcomp)
        np.testing.assert_allclose(
            _flat(dq)["w"], np.asarray(jgrad.ef_decompress_tree(jcomp)["w"]),
            rtol=1e-6)


def test_adam_int8_matches_jax():
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(4, 9)).astype(np.float32),
              "k": {"v": rng.normal(size=(2, 3, 5)).astype(np.float32),
                    "s": np.float32(0.5)}}
    jo, to = jopt.make_optimizer("adam_int8", 1e-2), \
        topt.make_optimizer("adam_int8", 1e-2)
    jp, tp = params, topt.tree_map(torch.as_tensor, params)
    js, ts = jo.init(jp), to.init(tp)
    update = jax.jit(jo.update)
    for step in range(3):
        g = {"w": rng.normal(size=(4, 9)).astype(np.float32),
             "k": {"v": rng.normal(size=(2, 3, 5)).astype(np.float32),
                   "s": np.float32(rng.normal())}}
        jp, js = update(g, js, jp, jnp.asarray(step))
        tp, ts = to.update(topt.tree_map(torch.as_tensor, g), ts, tp, step)
        for k, v in _flat(js).items():
            got = _flat(ts)[k]
            if k.endswith("q"):
                assert got.dtype == np.int8
                np.testing.assert_array_equal(got, v, err_msg=k)
            else:
                np.testing.assert_allclose(got, v, rtol=1e-6, err_msg=k)
        for k, v in _flat(jp).items():
            np.testing.assert_allclose(_flat(tp)[k], v, rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the LM's search tree, loss and cost
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [LLAMA, "gemma2-2b-smoke",
                                  "mamba2-780m-smoke"])
def test_init_params_mps_tree_matches_jax(arch):
    jcfg, tcfg = jreg.get(arch), treg.get(arch)
    want = _flat(jlm.init_params(jcfg, jax.random.key(0), mps_on=True))
    got = _flat(tlm.init_params(tcfg, device="cpu", mps_on=True))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if k.endswith("gamma"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert not any(k.startswith(("embed", "lm_head")) and "gamma" in k
                   for k in got)
    assert tlm.mps_param_count(tcfg) == jlm.mps_param_count(jcfg)


def test_bridge_checks_lm_trees(llama):
    _, tcfg, jp, _ = llama
    tree = jax.tree.map(np.asarray, jp)
    bad = jax.tree.map(lambda x: x, tree)
    bad["blocks"]["l0"]["mixer"]["wq"]["gamma"] = \
        tree["blocks"]["l0"]["mixer"]["wq"]["gamma"][:, :3]
    with pytest.raises(ValueError, match="gamma"):
        lm_params_from_jax(bad, cfg=tcfg)
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_jax({"blocks": tree["blocks"]})


@pytest.mark.parametrize("search", [False, True])
def test_loss_and_grads_match_jax(llama, search):
    jcfg, tcfg, jp, tp = llama
    lam = 1e-6 if search else 0.0
    jctx = jmps.SearchCtx(tau=1.0) if search else None
    tctx = tmps.SearchCtx(tau=1.0) if search else None
    jb, tb = _batch(jcfg, 0)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b, ctx=jctx, lam=lam)))(jp, jb)
    tl, tg = tgrad.value_and_grad(
        lambda p, b: tlm.loss_fn(tcfg, p, b, ctx=tctx, lam=lam), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    want, got = _flat(jg), _flat(tg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert _rel(got[k], v) < 3e-2, (k, _rel(got[k], v))
        if k.endswith("gamma"):
            # the search's selection logits learn; without it they idle
            assert (np.abs(got[k]).sum(axis=(1, 2)) > 0).all() == search, k


@pytest.mark.parametrize("arch", ["gemma2-2b-smoke", "qwen3-32b-smoke",
                                  "minicpm-2b-smoke"])
def test_loss_matches_jax_other_archs(arch):
    """Local/global windows with both softcaps (gemma2), qk-norm (qwen3)
    and minicpm, float and under the search."""
    jcfg, tcfg = jreg.get(arch), treg.get(arch)
    jp = jlm.init_params(jcfg, jax.random.key(1), mps_on=True)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg=tcfg)
    jb, tb = _batch(jcfg, 2)
    jctx, tctx = jmps.SearchCtx(tau=1.0), tmps.SearchCtx(tau=1.0)
    want = jax.jit(lambda p, b: (jlm.loss_fn(jcfg, p, b),
                                 jlm.loss_fn(jcfg, p, b, ctx=jctx,
                                             lam=1e-6)))(jp, jb)
    with torch.no_grad():
        got = (tlm.loss_fn(tcfg, tp, tb),
               tlm.loss_fn(tcfg, tp, tb, ctx=tctx, lam=1e-6))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4)


def test_mps_size_cost_matches_jax(llama):
    jcfg, tcfg, jp, tp = llama
    rng = np.random.default_rng(2)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: rng.normal(size=x.shape).astype(np.float32)
        if path[-1].key == "gamma" else x, jp)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg=tcfg)
    want = jax.jit(lambda p: jlm.mps_size_cost(jcfg, p,
                                               jmps.SearchCtx(tau=1.0)))(jp)
    got = tlm.mps_size_cost(tcfg, tp, tmps.SearchCtx(tau=1.0))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_ssm_train_mode_raises():
    """A Mamba-2 stack trains (``tests/test_torch_ssm_train.py``) on
    sequences its chunk tiles; 40 tokens at chunk 32 raise, where serving
    prefill would fall back to a divisor."""
    cfg = treg.get("mamba2-780m-smoke")
    params = tlm.init_params(cfg, device="cpu", mps_on=True)
    tokens = torch.zeros((1, 40), dtype=torch.int32)
    with pytest.raises(ValueError, match="chunk 32 tiles"):
        tlm.forward(cfg, params, {"tokens": tokens}, mode="train")


# ---------------------------------------------------------------------------
# K4 on the LM's channel-last weights
# ---------------------------------------------------------------------------

def test_mps_repair_routes_channel_last_weights_through_k4(monkeypatch):
    """``use_kernel=True`` takes ``mps_combine`` (its plain version on
    the CPU) for a (K, C_out) weight, forward and backward, and agrees
    with the plain quantizer stack; a weight K4 cannot take raises."""
    from repro_torch.kernels.mps_combine import ops as mops
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = mops.mps_combine_fwd, mops.mps_combine_bwd

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(mops, "mps_combine_fwd", count("fwd", fwd))
    monkeypatch.setattr(mops, "mps_combine_bwd", count("bwd", bwd))
    rng = np.random.default_rng(3)
    pw = (0, 2, 4, 8)
    w0 = rng.normal(size=(24, 10)).astype(np.float32) * 0.1
    g0 = rng.normal(size=(10, len(pw))).astype(np.float32)
    up = torch.as_tensor(rng.normal(size=(24, 10)).astype(np.float32))
    res = {}
    for use_kernel in (True, False):
        w = torch.tensor(w0, requires_grad=True)
        gm = torch.tensor(g0, requires_grad=True)
        out = tmps.effective_weight(w, gm, pw, tmps.SearchCtx(
            use_kernel=use_kernel), channel_axis=1)
        (out * up).sum().backward()
        res[use_kernel] = (out.detach(), w.grad, gm.grad)
    assert calls == {"fwd": 1, "bwd": 1}
    for a, b in zip(res[True], res[False]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    ctx = tmps.SearchCtx(use_kernel=True)
    with pytest.raises(TypeError, match="float32"):
        tmps.effective_weight(torch.tensor(w0).double(), torch.tensor(g0),
                              pw, ctx, channel_axis=1)
    with pytest.raises(ValueError, match="precisions"):
        tmps.effective_weight(torch.tensor(w0), torch.tensor(g0[:, :2]),
                              (0, 1), ctx, channel_axis=1)


# ---------------------------------------------------------------------------
# the training step, the plan it yields, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_jax(llama, microbatches):
    jcfg, tcfg, jp, tp = llama
    jcfg = dataclasses.replace(jcfg, train_microbatches=microbatches)
    tcfg = dataclasses.replace(tcfg, train_microbatches=microbatches)
    lr = 3e-4
    jo, to = jopt.make_optimizer("adam", lr), topt.make_optimizer("adam", lr)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jo, search=True))
    tstep = tsteps.make_train_step(tcfg, to, search=True)
    js, ts = jo.init(jp), to.init(tp)
    start = _flat(jp)
    for step in range(3):
        jb, tb = _batch(jcfg, step, batch=4, seq=17)
        jp, js, jl = jstep(jp, js, jb, jnp.asarray(step))
        tp, ts, tl = tstep(tp, ts, tb, step)
        np.testing.assert_allclose(float(tl), float(jl), rtol=2e-4)
    want, got = _flat(jp), _flat(tp)
    for k, v in want.items():
        assert np.abs(got[k] - v).max() <= 6 * lr, k
        rel = _rel(got[k] - start[k], v - start[k])
        assert rel < 0.15, (k, rel)


def test_extract_plan_matches_jax_and_serves(llama):
    jcfg, tcfg, jp, _ = llama
    rng = np.random.default_rng(4)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: rng.normal(size=x.shape).astype(np.float32)
        if path[-1].key == "gamma" else x, jp)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg=tcfg)
    want = jlm.extract_plan(jcfg, jp)
    got = tlm.extract_plan(tcfg, tp)
    assert got.groups == want.groups and len(got.groups) == 14
    for grp in want.groups:
        np.testing.assert_array_equal(got.channel_bits[grp],
                                      want.channel_bits[grp])
        np.testing.assert_array_equal(got.permutations[grp],
                                      want.permutations[grp])
    assert got.meta == want.meta == {"track": "lm", "arch": LLAMA}
    assert 0 < got.prune_fraction() < 1
    packed = got.bind(tlm.serve_weight_groups(tcfg, tp))
    assert sorted(packed) == list(got.groups)
    srv = teng.InferenceServer(tcfg, tp, got, max_len=32, max_batch=1,
                               cache="paged", page_size=8, device="cpu")
    out = srv.serve([Request(uid=0, prompt=np.array([5, 9, 2, 7]),
                             sampling=SamplingParams(max_tokens=4))])
    assert len(out[0]) == 4 and all(0 <= t < tcfg.vocab for t in out[0])


def _train(tmp_path, name, steps, extra=()):
    return ttrain.main(["--device", "cpu", "--arch", LLAMA, "--search",
                        "--steps", str(steps), "--seq", "16",
                        "--ckpt-dir", str(tmp_path / name), *extra])


def _assert_same_state(a, b):
    fa, fb = _flat(tree_to_numpy(a)), _flat(tree_to_numpy(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_train_launcher_resumes_bitwise(tmp_path):
    """A run stopped after 2 steps and one killed by SIGTERM each resume
    from their checkpoint to the state of an uninterrupted run, bit for
    bit."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", LLAMA, "--search", "--steps", "1000", "--seq", "16",
         "--ckpt-every", "1000", "--ckpt-dir", str(tmp_path / "killed")],
        stdout=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("[train] step 1 "):
            proc.send_signal(signal.SIGTERM)
            break
    lines += proc.stdout.readlines()
    assert proc.wait(timeout=60) == 0, "".join(lines)
    assert any("SIGTERM: checkpointed" in x for x in lines), "".join(lines)
    killed_at = max(int(x.split()[2]) for x in lines
                    if x.startswith("[train] step "))
    n = killed_at + 3
    full = _train(tmp_path, "full", n)
    _train(tmp_path, "stopped", 2)
    resumed = _train(tmp_path, "stopped", n)
    assert resumed["start"] == 2
    after_kill = _train(tmp_path, "killed", n)
    assert after_kill["start"] == killed_at + 1
    _assert_same_state(resumed["state"], full["state"])
    _assert_same_state(after_kill["state"], full["state"])
    assert resumed["losses"] == full["losses"][2:]
