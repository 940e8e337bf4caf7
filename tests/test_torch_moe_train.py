"""MoE training under the paper's joint search (C4 for MoE) in the port
against the JAX package on the CPU: ``llama4-scout-17b-a16e-smoke`` (one
super-block of 3 chunked + 1 full attention layers, 4 experts top-1 and
the shared FFN on every layer, float32 masters at smoke size) and
``arctic-480b-smoke`` (2 super-blocks of one layer, 4 experts top-2 and
the shared FFN), from one seeded numpy tree (``torch_train_cases``),
the JAX side under ``jax.jit`` as its training step runs.

Held, with their bounds and why:

* ``loss_fn`` without and with the search: rtol 1e-4 (measured at most
  5e-6: scout's chunked attention sums in another float32 order, so its
  MoE inputs differ in a few bf16 steps; arctic's are bitwise);
  ``mps_size_cost`` rtol 1e-6 (float32 sums in another order);
  ``mps_param_count`` equal;
* every MoE layer routes its tokens as the JAX package routes the same
  input, in the forward and in the train step (its remat recompute
  included); arctic's routing is the JAX package's own throughout;
* one ``make_train_step(search=True)`` step at the published training
  numerics (bf16 masters, ``adam_int8``, 2 micro-batches, remat): the
  loss rtol 1e-4 (bitwise for arctic), every gradient leaf -- the
  banks, their shared gammas and the routers among them -- within 3e-2
  relative L2 (the LM bound; measured at most 7.6e-3), each parameter
  within ``2 lr`` plus one bf16 step of the reference's and the int8
  state's scales within 3e-2 (``torch_train_cases.check_step`` says
  why);
* ``extract_plan``: the same groups (no expert bank, no router), bits
  and permutations from the same gammas;
* the XLA numerics on the MoE forward give ``jax.vjp``'s gradients
  (exp within rtol 1e-6, the softmax, router dot and bf16 products
  within the stated ULPs); an MoE layer's and a dense FFN's gradients
  are bitwise given the same input and cotangent (silu and
  ``matmul_f32`` differentiate as JAX does);
* K4's route (``core.mps.kernel_combine``, its plain version on the
  CPU) takes a bank ``(E, K, C_out)`` against its one gamma and agrees
  with the plain quantizer stack; ``adam_int8``'s blocked update of a
  large leaf gives the whole leaf's bits;
* ``launch/train.py --arch arctic-480b-smoke --search`` trains and
  prints its plan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_train_cases as tc
from repro.configs import registry as jreg
from repro.nn import blocks as jblocks
from repro_torch.bridge import (lm_params_from_jax, opt_state_from_jax,
                                params_from_jax, tree_to_numpy)
from repro_torch.configs import registry as treg
from repro_torch.core import mps as tmps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.nn import blocks as tb
from repro_torch.nn import xla_numerics as xla
from repro_torch.optim import optimizers as topt
from torch_threads import _one_torch_thread  # noqa: F401

SCOUT, ARCTIC = "llama4-scout-17b-a16e-smoke", "arctic-480b-smoke"


@pytest.fixture(scope="module", params=[SCOUT, ARCTIC])
def world(request):
    return tc.train_world(request.param)


def test_losses_and_size_cost_match_jax(world):
    tc.check_losses(world)


def test_routing_matches_jax(world):
    """Each MoE call keeps the tokens the JAX package's routing of the
    same input keeps, in the forward (float and searched) and in the
    train step (each micro-batch's forward and remat recompute, a bf16
    router of bf16 masters: ``xla_numerics.softmax``' bf16 path).
    arctic's routing is the JAX package's own in every call; scout's
    chunked attention sums in another float32 order, its later layers'
    inputs differ in bf16 steps, and 1 of its 8 forward calls and 4 of
    its 16 step calls keep another token at an expert's capacity (the
    gradients stay within the LM bound)."""
    fwd, step = tc.check_routing(world)
    most = (0, 0) if world["arch"] == ARCTIC else (1, 4)
    assert fwd <= most[0] and step <= most[1], (fwd, step)


def test_train_step_matches_jax(world):
    tc.check_step(world)


def test_extract_plan_matches_jax(world):
    plan = tc.check_plan(world)
    n_moe = sum(s.ffn == "moe" for s in tlm.block_pattern(world["tcfg"]))
    per_sb = len(tlm._plan_weights(world["tcfg"]))
    assert len(plan.groups) == per_sb * tlm.n_superblocks(world["tcfg"])
    assert per_sb == 4 * len(tlm.block_pattern(world["tcfg"])) + 3 * n_moe


def test_bridge_carries_the_trained_search_tree(world):
    """The JAX package's trained bf16 tree (bank gammas in float32) and
    its ``adam_int8`` state come into the port bit for bit; a state
    whose scales took the codes' shape, or that lost a leaf, raises."""
    jnew, jstate = world["step_jax"]
    tnew = lm_params_from_jax(jnew, cfg=world["step_cfg"][1])
    assert tnew["blocks"]["l0"]["ffn"]["w_up"]["w"].dtype == torch.bfloat16
    for k, v in tc.flat(tnew).items():
        np.testing.assert_array_equal(v, world["step_params"][0][k])
    got = opt_state_from_jax(jstate, jnew)
    for k, v in tc.flat(got).items():
        np.testing.assert_array_equal(v, world["step_state"][0][k])
    bad = jax.tree.map(lambda x: x, jstate)
    bad["embed"]["w"]["ms"] = bad["embed"]["w"]["mq"].astype(np.float32)
    with pytest.raises(ValueError, match="embed.w"):
        opt_state_from_jax(bad, jnew)
    del bad["embed"]
    with pytest.raises(ValueError, match="state holds"):
        opt_state_from_jax(bad, jnew)


# ---------------------------------------------------------------------------
# the numerics under the MoE forward, and its backward
# ---------------------------------------------------------------------------

def _vjp_pair(jf, tf, args, cot, dtype=np.float32, cot_dtype=None):
    """(port, JAX) gradients of ``f(*args)`` (arguments in ``dtype``)
    against cotangent ``cot`` (in ``cot_dtype``, default ``dtype``)."""
    cot_dtype = cot_dtype or dtype
    jargs = [jnp.asarray(a).astype(dtype) for a in args]
    _, vjp = jax.vjp(jf, *jargs)
    jg = jax.jit(lambda c: vjp(c))(jnp.asarray(cot).astype(cot_dtype))

    def tdt(d):
        return torch.bfloat16 if d == jnp.bfloat16 else torch.float32

    targs = [torch.tensor(a).to(tdt(dtype)).requires_grad_() for a in args]
    tf(*targs).backward(torch.tensor(cot).to(tdt(cot_dtype)))
    return ([t.grad.float().numpy() for t in targs],
            [np.asarray(g, np.float32) for g in jg])


@pytest.mark.parametrize("fn", ["exp", "softmax_f32", "softmax_bf16",
                                "dot_f32", "matmul", "matmul_f32"])
def test_xla_numerics_give_jax_gradients(fn):
    """Autograd through the port's copies of XLA's CPU arithmetic gives
    ``jax.vjp``'s gradients: the exp polynomial's derivative within
    rtol 1e-6 of ``exp``; the float32 softmax and the router's float32
    dot within 2e-6 of the largest gradient (float32 sums in another
    order); the bf16 softmax (a bf16 router) within two bf16 steps of
    its largest gradient and 1e-2 relative L2 (measured one step, 3.8e-3:
    its backward takes the roundings of XLA's compiled backward inside
    an MoE layer, bitwise there in
    ``tests/test_torch_hybrid_train.py::test_gradient_gap_enters_at_the_mamba_layers[moe]``;
    compiled alone, XLA fuses the softmax's ops otherwise); the bf16
    products (``matmul``; ``matmul_f32`` through its own backward)
    bitwise."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(48, 4)) * 3).astype(np.float32)
    g = rng.normal(size=(48, 4)).astype(np.float32)
    if fn == "exp":
        got, want = _vjp_pair(jnp.exp, xla.xla_exp, [x], g)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        return
    if fn.startswith("softmax"):
        dt = jnp.bfloat16 if fn.endswith("bf16") else np.float32
        got, want = _vjp_pair(lambda v: jax.nn.softmax(v, -1),
                              xla.softmax, [x], g, dt)
        tol = 2e-6 if dt == np.float32 else 2 ** -6
        assert np.abs(got[0] - want[0]).max() <= tol * np.abs(want[0]).max()
        assert tc.rel(got[0], want[0]) < (1e-6 if dt == np.float32
                                          else 1e-2)
        return
    a = rng.normal(size=(4, 40, 64)).astype(np.float32) * 0.5
    b = rng.normal(size=(4, 64, 16)).astype(np.float32) * 0.5
    c = rng.normal(size=(4, 40, 16)).astype(np.float32)
    if fn == "dot_f32":
        got, want = _vjp_pair(lambda p, q: p @ q, xla.dot_f32,
                              [a[0], b[0]], c[0])
        for u, v in zip(got, want):
            assert np.abs(u - v).max() <= 2e-6 * np.abs(v).max()
        return
    if fn == "matmul":
        got, want = _vjp_pair(lambda p, q: p @ q, xla.matmul, [a, b], c,
                              jnp.bfloat16)
    else:
        got, want = _vjp_pair(lambda p, q: (p @ q).astype(jnp.float32),
                              xla.matmul_f32, [a, b], c, jnp.bfloat16,
                              np.float32)
    for u, v in zip(got, want):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("layer", ["moe", "ffn"])
def test_layer_backward_is_bitwise_given_the_same_cotangent(layer):
    """arctic-smoke's MoE layer (top-2 over 4 experts, the shared FFN)
    and its dense SwiGLU FFN: from one bf16 input and one cotangent the
    port's gradients of the banks, the shared FFN and the FFN weights
    equal the JAX package's bit for bit, the router's and the input's
    within 2e-6 relative L2 (float32 router sums in another order).
    Before silu and ``matmul_f32`` differentiated as JAX does, the
    FFN's input gradient was 3.3e-3 off and ``w_down``'s 2.7e-3."""
    jcfg, tcfg = jreg.get(ARCTIC), treg.get(ARCTIC)
    tree = tree_to_numpy(tlm.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu"))
    ffn = jax.tree.map(lambda a: a[0], tree["blocks"]["l0"]["ffn"])
    if layer == "ffn":
        ffn = ffn["shared"]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, tcfg.d_model)).astype(np.float32)
    ct = rng.normal(size=(2, 32, tcfg.d_model)).astype(np.float32) * 0.01

    def jf(p, v):
        getw = lambda pp: pp["w"].astype(jnp.bfloat16)  # noqa: E731
        if layer == "ffn":
            return jblocks.ffn_swiglu(p, v, effective_w=getw)
        return jblocks.moe_layer(p, v, jcfg, effective_w=getw)

    jx = jnp.asarray(x).astype(jnp.bfloat16)
    y, vjp = jax.jit(lambda p, v: jax.vjp(jf, p, v))(
        jax.tree.map(jnp.asarray, ffn), jx)
    jgp, jgx = jax.jit(lambda c: vjp(c))(jnp.asarray(ct).astype(y.dtype))
    tp = topt.tree_map(lambda t: t.clone().requires_grad_(),
                       params_from_jax(ffn))
    tx = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    getw = lambda pp: pp["w"].to(torch.bfloat16)  # noqa: E731
    ty = tb.ffn_swiglu(tp, tx, effective_w=getw) if layer == "ffn" else \
        tb.moe_layer(tp, tx, tcfg, effective_w=getw)
    np.testing.assert_array_equal(ty.detach().float().numpy(),
                                  np.asarray(y, np.float32))
    ty.backward(torch.tensor(ct).to(ty.dtype))
    assert tc.rel(tx.grad.float().numpy(), np.asarray(jgx, np.float32)) < 2e-6
    want = tc.flat(jgp)
    for k, v in tc.flat(topt.tree_map(lambda t: t.grad, tp)).items():
        if k.startswith("router"):
            assert tc.rel(v, want[k]) < 2e-6, k
        else:
            np.testing.assert_array_equal(v, want[k], err_msg=k)


# ---------------------------------------------------------------------------
# K4 on a bank, the blocked int8 update, the launcher
# ---------------------------------------------------------------------------

def test_kernel_combine_takes_a_bank(monkeypatch):
    """``effective_weight`` of a bank ``(E, K, C_out)`` with
    ``channel_axis=2`` through K4's route (``use_kernel=True``: the
    channel axis moved to the front, ``C_out`` rows of ``E * K``, K4's
    plain version on the CPU) equals the plain quantizer stack, whose
    absmax runs over all of E and K, forward and backward (rtol 1e-5:
    the two sum the precisions in another order); one launch each way."""
    from repro_torch.kernels.mps_combine import ops as mops
    seen = []
    fwd = mops.mps_combine_fwd

    def spy(w, *a, **k):
        seen.append(tuple(w.shape))
        return fwd(w, *a, **k)

    monkeypatch.setattr(mops, "mps_combine_fwd", spy)
    rng = np.random.default_rng(5)
    pw = (0, 2, 4, 8)
    w0 = rng.normal(size=(3, 12, 10)).astype(np.float32) * 0.1
    w0[1, 4, 7] = 2.0         # one expert's outlier sets channel 7's scale
    g0 = rng.normal(size=(10, len(pw))).astype(np.float32)
    up = torch.as_tensor(rng.normal(size=w0.shape).astype(np.float32))
    res = {}
    for use_kernel in (True, False):
        w = torch.tensor(w0, requires_grad=True)
        gm = torch.tensor(g0, requires_grad=True)
        out = tmps.effective_weight(w, gm, pw, tmps.SearchCtx(
            use_kernel=use_kernel), channel_axis=2)
        (out * up).sum().backward()
        res[use_kernel] = (out.detach(), w.grad, gm.grad)
    assert seen == [(10, 36)]
    for a, b in zip(res[True], res[False]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # channel 7 quantized on the outlier's scale in every expert
    q8 = torch.tensor(w0)[..., 7] / (2.0 / 127)
    assert float(q8.abs().max()) == pytest.approx(127.0)


def test_adam_int8_blocks_give_the_whole_leaf(monkeypatch):
    """A leaf larger than ``UPDATE_BLOCK`` is updated a block of rows at
    a time: three steps give the same parameters and int8 state, bit
    for bit, as the whole leaf at once."""
    g = torch.Generator().manual_seed(0)
    params = {"bank": torch.randn(3, 5, 40, generator=g).to(torch.bfloat16),
              "v": torch.randn(7, generator=g),
              "m": torch.randn(33, 17, generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g).to(v.dtype)
              for k, v in params.items()} for _ in range(3)]
    opt = topt.adam_int8(1e-2)

    def run(block):
        monkeypatch.setattr(topt, "UPDATE_BLOCK", block)
        p, s = params, opt.init(params)
        for i, gr in enumerate(grads):
            p, s = opt.update(gr, s, p, i)
        return tc.flat(p), tc.flat(s)

    whole, blocked = run(1 << 26), run(50)
    for a, b in zip(whole, blocked):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_launcher_on_arctic():
    """``launch/train.main`` trains arctic-480b-smoke under the search
    on the CPU and ends with the plan ``extract_plan`` takes."""
    out = ttrain.main(["--device", "cpu", "--arch", ARCTIC, "--search",
                       "--steps", "2"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    cfg = treg.get(ARCTIC)
    plan = tlm.extract_plan(cfg, out["state"]["params"])
    assert len(plan.groups) == 7 * tlm.n_superblocks(cfg)
    dtypes = {str(v.dtype) for v in tc.flat(out["state"]["params"]).values()}
    assert dtypes == {"float32"}        # the smoke config's masters
