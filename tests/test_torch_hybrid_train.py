"""Hybrid (jamba) training under the paper's joint search in the port
against the JAX package on the CPU, on ``jamba-1.5-large-398b-smoke``
(one super-block of 8 layers: Mamba-2 on every slot but 4, attention on
slot 4, a dense FFN on the even slots and top-2 MoE over 4 experts on
the odd ones), from one seeded numpy tree (``torch_train_cases``), the
JAX side under ``jax.jit`` as its training step runs.

Held, with their bounds and why:

* ``loss_fn`` without and with the search: rtol 1e-4 (measured 8e-6;
  the searched loss is bitwise); ``mps_size_cost`` rtol 1e-6;
  ``mps_param_count`` equal;
* every MoE layer routes its tokens as the JAX package routes the same
  input (where the inputs part by bf16 steps, a token may cross an
  expert's capacity in one package only);
* one ``make_train_step(search=True)`` step at the published training
  numerics (bf16 masters, ``adam_int8``, 2 micro-batches, remat): the
  loss rtol 1e-4; each gradient leaf within 6e-2 relative L2 and the
  median leaf within 1.5e-2 (measured 4.7e-2, ``a_log`` of slot 2, and
  1.07e-2); each parameter moved as the reference's (``check_step``);
  the int8 state's scales within 6e-2.  The dense and MoE families
  hold 3e-2 (``tests/test_torch_moe_train.py``).  Here every kind of
  layer gives the JAX package's gradients bit for bit alone
  (``test_gradient_gap_enters_at_the_mamba_layers``), and the stack's
  gap is XLA fusing across layers, which the port does not mirror
  (``test_stack_gap_is_xla_fusing_the_residual_add``).  It is the size
  of the JAX package's own: its step's gradients move by up to 3.0e-2
  (median 9.7e-3) when only remat changes
  (``tests/torch_remat_spread.py``), the same leaves (``dt_bias``,
  ``a_log``, conv weights: sums that cancel) first;
* remat: the port's recompute routes exactly as its forward did (the
  MoE inputs are bitwise) and equals the JAX package's recompute at its
  first MoE input; the JAX package's own forward is not its recompute
  (XLA compiles the two apart: its MoE inputs part by up to 3.2e-2
  relative L2), a reference quirk the port does not mirror;
* ``extract_plan``: the same groups (no expert bank, no router), bits
  and permutations from the same gammas;
* ``launch/train.py --arch jamba-1.5-large-398b-smoke --search`` trains
  and prints its plan; a ``--seq`` the SSD chunk does not tile exits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_train_cases as tc
from repro.configs import registry as jreg
from repro.nn import blocks as jblocks
from repro_torch.bridge import params_from_jax, tree_to_numpy
from repro_torch.configs import registry as treg
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.nn import blocks as tb
from repro_torch.optim import optimizers as topt
from torch_threads import _one_torch_thread  # noqa: F401

ARCH = "jamba-1.5-large-398b-smoke"


@pytest.fixture(scope="module")
def world():
    return tc.train_world(ARCH)


def test_losses_and_size_cost_match_jax(world):
    tc.check_losses(world)
    assert world["tloss"][1] == world["jloss"][1]


def test_routing_matches_jax(world):
    """Every MoE call keeps the tokens the JAX package's routing of the
    same input keeps.  In the forward that is the JAX package's own
    routing, but for one call: the searched forward's MoE inputs are
    bitwise; the float forward's part after the attention layer (slot 4:
    its float32 arithmetic, ROADMAP section 3) in bf16 steps that move a
    token at one of slots 5 and 7.  In the step 10 of 16 calls route
    otherwise than the JAX package's own: its forward is not its
    recompute (below), and from slot 4 on XLA's fusion across layers
    parts the inputs by bf16 steps."""
    fwd, step = tc.check_routing(world)
    assert fwd <= 1 and step <= 10, (fwd, step)
    jin, tin = world["moe_in"]
    n = len(tc.moe_calls(world))
    for x, t in zip(jin[n:], tin[n:]):
        np.testing.assert_array_equal(t, x)
    for x, t in zip(jin[:2], tin[:2]):          # slots 1 and 3, float
        np.testing.assert_array_equal(t, x)


def test_train_step_matches_jax(world):
    tc.check_step(world, grad_max=6e-2, grad_median=1.5e-2)


def test_remat_recomputes_the_forward(world):
    """Each micro-batch's remat recompute hands every MoE layer the input
    its forward did, bit for bit, in the port; in the JAX package it
    does not (measured up to 3.2e-2 relative L2): XLA compiles its
    forward, which saves nothing for the backward, apart from its
    recompute, which does (a Mamba-2 layer's B and C are rounded to bf16
    in the second only).  The port's passes are the recompute's: its
    first recompute's first MoE input is the JAX package's bit for bit.
    A reference quirk the port does not mirror (ROADMAP section 3)."""
    jin, tin = world["step_moe_in"]
    n = len(tc.moe_calls(world))
    assert len(tin) == 2 * 2 * n           # 2 micro-batches, remat
    jax_gap = 0.0
    for m in range(2):
        base = 2 * n * m
        for i in range(n):
            np.testing.assert_array_equal(tin[base + n + i], tin[base + i])
            jax_gap = max(jax_gap, tc.rel(jin[base + n + i], jin[base + i]))
    np.testing.assert_array_equal(tin[n], jin[n])
    assert 1e-3 < jax_gap < 0.1, jax_gap


def _layer_vjp(layer, x, ct, residual=None, round_sum=True):
    """One jamba-smoke layer at the step's numerics (bf16 parameters and
    input, the search's effective weights), from ``x`` and the cotangent
    ``ct``: the JAX package's output and gradients (one ``jax.jit`` of
    ``jax.vjp``) and the port's.  ``attention`` is slot 4's norm and
    attention; with ``residual`` it takes ``rmsnorm(x + residual)``, the
    port's sum rounded to bf16 (``round_sum``) or not; without it the
    attention takes ``x`` itself."""
    import ml_dtypes
    from repro.core import mps as jmps
    from repro.models import lm as jlm
    from repro_torch.core import mps as tmps
    jcfg, tcfg = jreg.get(ARCH), treg.get(ARCH)
    tree = tree_to_numpy(tlm.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu", mps_on=True))
    slot, sub = {"moe": ("l1", "ffn"), "mamba": ("l0", "mixer"),
                 "attention": ("l4", "mixer")}[layer]
    p = jax.tree_util.tree_map_with_path(
        lambda path, a: a[0] if path[-1].key == "gamma"
        else a[0].astype(ml_dtypes.bfloat16), tree["blocks"][slot][sub])
    norm = tree["blocks"][slot]["norm1"][0].astype(ml_dtypes.bfloat16)
    jgetw = jlm._make_effective_w(jmps.SearchCtx(tau=1.0),
                                  jcfg.mps_precisions)
    tgetw = tlm._make_getw(tcfg, tmps.SearchCtx(tau=1.0))

    def jf(pp, v):
        if layer == "moe":
            return jblocks.moe_layer(pp, v, jcfg, effective_w=jgetw)
        if layer == "mamba":
            return jblocks.mamba2_layer(pp, v, jcfg, mode="train",
                                        effective_w=jgetw)[0]
        if residual is not None:
            v = jblocks.rmsnorm(v + jnp.asarray(residual).astype(
                jnp.bfloat16), jnp.asarray(norm), jcfg.norm_eps)
        return jblocks.attention_layer(pp, v, jcfg, mode="train",
                                       effective_w=jgetw)[0]

    def both(pp, v, c):
        y, vjp = jax.vjp(jf, pp, v)
        return y, vjp(c)

    y, (jgp, jgx) = jax.jit(both)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(ct).astype(jnp.bfloat16))
    tp = topt.tree_map(lambda t: t.clone().requires_grad_(),
                       params_from_jax(p))
    tx = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    if layer == "moe":
        ty = tb.moe_layer(tp, tx, tcfg, effective_w=tgetw)
    elif layer == "mamba":
        ty = tb.mamba2_layer(tp, tx, tcfg, mode="train",
                             effective_w=tgetw)[0]
    else:
        v = tx
        if residual is not None:
            r = torch.tensor(residual).to(torch.bfloat16)
            v = tx + r if round_sum else tx.float() + r.float()
            v = tb.rmsnorm(v, torch.tensor(norm.astype(np.float32)).to(
                torch.bfloat16), tcfg.norm_eps).to(torch.bfloat16)
        ty = tb.attention_layer(tp, v, tcfg, mode="train",
                                effective_w=tgetw)[0]
    ty.backward(torch.tensor(ct).to(ty.dtype))
    got = {"y": ty.detach().float().numpy(), "x": tx.grad.float().numpy(),
           **tc.flat(topt.tree_map(lambda t: t.grad, tp))}
    want = {"y": np.asarray(y, np.float32), "x": np.asarray(jgx, np.float32),
            **tc.flat(jgp)}
    return got, want


@pytest.mark.parametrize("layer", ["moe", "mamba", "attention"])
def test_gradient_gap_enters_at_the_mamba_layers(layer):
    """From one bf16 input and one cotangent at the step's numerics (bf16
    parameters, the search's effective weights), each kind of layer of
    the hybrid gives the JAX package's output and gradients bit for bit:
    the MoE layer, slot 4's attention, and a Mamba-2 layer but for
    ``in_b`` and ``in_x`` (one or two values a step apart, measured
    2.9e-4 and 6.6e-5 relative L2: the SSD's float32 sums in another
    order; with the SSD in float64 they are bitwise); the gammas'
    float32 gradients within 1e-5 (K4's plain version sums in another
    order).  The gap used to
    enter at the Mamba-2 layers: 5e-3 in their input gradient, from four
    faults of the port fixed since (B and C rounded to bf16 where XLA
    saves them for the backward, the gate's gradient, ``dt_bias``' and
    the conv weights' gradients summed as XLA sums bf16, the bf16 router
    softmax's gradient), ROADMAP section 3."""
    s = 32 if layer == "attention" else 64      # the step's 32 tokens
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    ct = rng.normal(size=(2, s, 64)).astype(np.float32) * 0.01
    got, want = _layer_vjp(layer, x, ct)
    assert sorted(got) == sorted(want)
    near = ("in_b/w", "in_x/w") if layer == "mamba" else ()
    gaps = {k: tc.rel(got[k], v) for k, v in want.items()}
    bad = {k: g for k, g in gaps.items() if not (
        g < 1e-3 if k in near else g < 1e-5 if k.endswith("gamma")
        else np.array_equal(got[k], want[k]))}
    assert not bad, bad


def test_stack_gap_is_xla_fusing_the_residual_add():
    """Why the stack's gradients part where each layer's are bitwise:
    XLA fuses across layers.  Slot 4's norm and attention behind a
    residual add ``x + r``: XLA keeps the sum unrounded into the norm
    where it fuses the two, so the port's layer with the bf16 sum (what
    it computes, and what the stack's earlier slots match bitwise) is
    5.8e-3 off JAX's output; with the sum left in float32 the output is
    bitwise and the q, k and v weights' gradients within 1e-3 (measured
    1.8e-4).  (The norm's input gradient stays 2.5e-3 off: XLA adds the
    three projections' gradients in bf16 but keeps the last sum in
    float32 into the norm's backward, where autograd rounds it.)  Where
    XLA fuses so is a property of
    the whole compiled program (slots 0 to 3 of the same step take the
    rounded sum), which the port does not mirror."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 32, 64)).astype(np.float32)
    r = (rng.normal(size=(2, 32, 64)) * 0.3).astype(np.float32)
    ct = rng.normal(size=(2, 32, 64)).astype(np.float32) * 0.01
    got, want = _layer_vjp("attention", x, ct, residual=r)
    assert tc.rel(got["y"], want["y"]) > 1e-3
    got, want = _layer_vjp("attention", x, ct, residual=r, round_sum=False)
    np.testing.assert_array_equal(got["y"], want["y"])
    for k in ("wq/w", "wk/w", "wv/w"):
        assert tc.rel(got[k], want[k]) < 1e-3, (k, tc.rel(got[k], want[k]))


def test_extract_plan_matches_jax(world):
    plan = tc.check_plan(world)
    assert len(plan.groups) == 58            # 7 x 6 + 4 + 4 x 3


def test_train_launcher_on_jamba(capsys):
    """``launch/train.main`` trains the hybrid under the search on the
    CPU and prints its plan; a sequence the SSD chunk does not tile
    exits with an error before training."""
    out = ttrain.main(["--device", "cpu", "--arch", ARCH, "--search",
                       "--steps", "2", "--batch", "2", "--seq", "32"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    lines = capsys.readouterr().out.splitlines()
    assert sum(x.startswith("[train] step ") for x in lines) == 2
    assert any("CompressionPlan(58 groups" in x for x in lines), lines
    with pytest.raises(SystemExit, match="multiple"):
        ttrain.main(["--device", "cpu", "--arch", ARCH, "--search",
                     "--steps", "1", "--seq", "40"])
