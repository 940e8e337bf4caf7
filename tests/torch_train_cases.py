"""What ``tests/test_torch_moe_train.py`` and
``tests/test_torch_hybrid_train.py`` share: MoE and hybrid training under
the paper's joint search in both packages, from one numpy tree.

``train_world(arch)`` compiles the JAX side twice and runs the port
beside it on the CPU:

* the forward (``jax.jit``): ``loss_fn`` without and with the search,
  ``mps_size_cost``, and each MoE layer's input (``jax.debug.callback``
  on ``blocks._moe_local``);
* one ``make_train_step(search=True)`` step of the arch at its published
  training numerics -- bf16 master weights, ``adam_int8``,
  ``train_microbatches=2`` and, on a stack whose published config has
  it, remat (a ``dataclasses.replace`` of the smoke config) -- whose
  optimizer also hands back the gradients it was given (after the
  global-norm clip), so one compile gives the step's loss, every
  gradient leaf, the new parameters and the int8 state.

Both packages start from the port's ``init_params(mps_on=True)`` tree
drawn from seed 0 (``bridge.tree_to_numpy``; the JAX package's eager
``init_params`` compiles every draw), carried into the port by
``bridge.lm_params_from_jax``.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.core import mps as jmps
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.nn import blocks as jblocks
from repro.optim import optimizers as jopt
from repro_torch.bridge import lm_params_from_jax, tree_to_numpy
from repro_torch.configs import registry as treg
from repro_torch.core import mps as tmps
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.nn import blocks as tb
from repro_torch.optim import optimizers as topt

LAM = 1e-6
LR = 3e-4
STEP_NUMERICS = dict(param_dtype="bfloat16", optimizer="adam_int8",
                     train_microbatches=2)


def flat(tree, prefix=""):
    """``{"a/b": float numpy}`` of a JAX or port tree (bf16 leaves in
    float32; int8 codes kept)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    if torch.is_tensor(tree):
        t = tree.detach()
        return {prefix[:-1]: (t if t.dtype == torch.int8 else t.float())
                .numpy()}
    a = np.asarray(tree)
    return {prefix[:-1]: a if a.dtype == np.int8 else a.astype(np.float32)}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _capturing(make, inner):
    """An optimizer of package ``make`` (``Optimizer``) that runs
    ``inner`` and keeps the gradients it was handed in its state."""
    def init(params):
        return {"inner": inner.init(params), "grads": None}

    def update(grads, state, params, step, *axes):
        new_p, new_s = inner.update(grads, state["inner"], params, step,
                                    *axes)
        return new_p, {"inner": new_s, "grads": grads}

    return make(init, update)


def batch(cfg, step, b, seq):
    """``lm_batch`` in both packages (identical integers)."""
    jb = jsyn.lm_batch(cfg.vocab, seq, b, step)
    tb_ = tsyn.lm_batch(cfg.vocab, seq, b, step)
    return jb, tb_


def train_world(arch: str, seq: int = 33):
    """Everything the two test files hold, computed once per arch."""
    jcfg, tcfg = jreg.get(arch), treg.get(arch)
    pub = treg.get(arch[:-len("-smoke")])
    tree = tree_to_numpy(tlm.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu", mps_on=True))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = lm_params_from_jax(tree, cfg=tcfg)
    w = dict(arch=arch, jcfg=jcfg, tcfg=tcfg, tree=tree, jp=jp, tp=tp)

    # the forward: losses, size cost and the MoE layers' inputs
    jb, tb_ = batch(jcfg, 0, 2, seq)
    jctx, tctx = jmps.SearchCtx(tau=1.0), tmps.SearchCtx(tau=1.0)
    with moe_taps() as (jin, tin, troute):
        jl = jax.block_until_ready(jax.jit(lambda p, b: (
            jlm.loss_fn(jcfg, p, b), jlm.loss_fn(jcfg, p, b, ctx=jctx,
                                                 lam=LAM),
            jlm.mps_size_cost(jcfg, p, jctx)))(jp, jb))
        with torch.no_grad():
            tl = (tlm.loss_fn(tcfg, tp, tb_),
                  tlm.loss_fn(tcfg, tp, tb_, ctx=tctx, lam=LAM),
                  tlm.mps_size_cost(tcfg, tp, tctx))
    w.update(jloss=[float(v) for v in jl], tloss=[float(v) for v in tl],
             moe_in=(jin, tin), troute=troute, batch0=(jb, tb_))

    # one training step at the published numerics, gradients captured
    kw = dict(STEP_NUMERICS, remat=pub.remat)
    jcs, tcs = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg,
                                                                    **kw)
    stree = tree_to_numpy(_cast_tree(tp))
    jsp = jax.tree.map(jnp.asarray, stree)
    tsp = lm_params_from_jax(stree, cfg=tcs)
    jo = _capturing(jopt.Optimizer, jopt.make_optimizer("adam_int8", LR))
    to = _capturing(topt.Optimizer, topt.make_optimizer("adam_int8", LR))
    jb, tb_ = batch(jcfg, 1, 4, seq)
    jstep = jax.jit(jsteps.make_train_step(jcs, jo, search=True))
    tstep = tsteps.make_train_step(tcs, to, search=True)
    with moe_taps() as (jin, tin, troute):
        jnew, jstate, jloss = jax.block_until_ready(
            jstep(jsp, jo.init(jsp), jb, jnp.asarray(0)))
        tnew, tstate, tloss = tstep(tsp, to.init(tsp), tb_, 0)
    w.update(step_moe_in=(jin, tin), step_route=troute,
             step_cfg=(jcs, tcs), step_start=flat(stree),
             step_loss=(float(jloss), float(tloss)),
             step_params=(flat(jnew), flat(tnew)),
             step_grads=(flat(jstate["grads"]), flat(tstate["grads"])),
             step_state=(flat(jstate["inner"]), flat(tstate["inner"])),
             step_tree=stree, step_jax=(jax.tree.map(np.asarray, jnew),
                                        jax.tree.map(np.asarray,
                                                     jstate["inner"])),
             step_grad_norm=float(tstep.grad_norm))
    return w


@contextlib.contextmanager
def moe_taps():
    """Collect every MoE layer's input in both packages, in call order:
    the JAX package's through an ordered ``jax.debug.callback`` on
    ``blocks._moe_local`` (a trace-time patch: only a function first
    traced inside the block is tapped), the port's through
    ``blocks.moe_route`` with its routing (gates, ids, top_g, top_i)."""
    jin, tin, troute = [], [], []
    j_inner, t_inner = jblocks._moe_local, tb.moe_route

    def jtap(x, *a, **k):
        jax.debug.callback(lambda v: jin.append(np.asarray(v, np.float32)),
                           x, ordered=True)
        return j_inner(x, *a, **k)

    def ttap(x, router_w, **k):
        out = t_inner(x, router_w, **k)
        tin.append(x.detach().float().numpy())
        troute.append(tuple(t.detach().float().numpy() for t in out))
        return out

    jblocks._moe_local, tb.moe_route = jtap, ttap
    try:
        yield jin, tin, troute
    finally:
        jblocks._moe_local, tb.moe_route = j_inner, t_inner


def _cast_tree(tree):
    """A port tree with every leaf but the gammas cast to bf16 (the
    published master dtype; gammas stay float32, as ``init_params``
    makes them)."""
    return {k: _cast_tree(v) if isinstance(v, dict) else
            (v if k == "gamma" else v.to(torch.bfloat16))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the checks both files run
# ---------------------------------------------------------------------------

def check_losses(w, rtol=1e-4):
    """``loss_fn`` without and with the search within ``rtol``;
    ``mps_size_cost`` within 1e-6; ``mps_param_count`` equal."""
    for got, want in zip(w["tloss"][:2], w["jloss"][:2]):
        np.testing.assert_allclose(got, want, rtol=rtol)
    np.testing.assert_allclose(w["tloss"][2], w["jloss"][2], rtol=1e-6)
    assert tlm.mps_param_count(w["tcfg"]) == jlm.mps_param_count(w["jcfg"])


def moe_calls(w, step=False):
    """(router weight, capacity) of each MoE call, in call order: of one
    forward over the world's forward batch, or (``step``) of the train
    step, each micro-batch's forward and then, under remat, its
    recompute, super-blocks in reverse (the backward's order)."""
    cfg = w["step_cfg"][1] if step else w["tcfg"]
    tree = w["step_tree"] if step else w["tree"]
    b, s = w["batch0"][1]["tokens"].shape      # a micro-batch's shape too
    cap = max(1, int(np.ceil(b * s * cfg.experts_per_token
                             * cfg.capacity_factor / cfg.n_experts)))
    slots = [i for i, sp in enumerate(tlm.block_pattern(cfg))
             if sp.ffn == "moe"]
    nsb = tlm.n_superblocks(cfg)

    def sweep(order):
        return [(tree["blocks"][f"l{i}"]["ffn"]["router"]["w"][j], cap)
                for j in order for i in slots]

    fwd = sweep(range(nsb))
    if not step:
        return fwd
    re = sweep(reversed(range(nsb))) if cfg.remat else []
    return (fwd + re) * cfg.train_microbatches


@functools.partial(jax.jit, static_argnames=("top_k", "capacity"))
def _route(x, rw, top_k, capacity):
    probs = jax.nn.softmax(x @ rw, axis=-1)
    gates, ids = jax.lax.top_k(probs, top_k)
    return jnp.stack([jax.lax.top_k(jnp.sum(gates * (ids == e), -1),
                                    capacity)[1]
                      for e in range(rw.shape[1])])


def jax_routing(x, router_w, top_k, capacity):
    """The routing of ``repro.nn.blocks._moe_local`` (every expert
    local) on ``x``: each expert's kept token ids, (E, C)."""
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    return np.asarray(_route(xb, jnp.asarray(router_w), top_k, capacity))


def check_routing(w, bitwise_inputs=False):
    """Each MoE call's kept tokens (the port's ``top_i``) equal the JAX
    package's routing of the same input -- the router, its softmax
    (float32, or bf16 with bf16 masters) and both top-k's are exact --
    in the forward (float, then searched) and in the train step; with
    ``bitwise_inputs`` the MoE inputs themselves are equal too, so the
    routing is the JAX package's own.  Returns the number of calls whose
    routing differs from the JAX package's own (inputs that differ by
    bf16 steps may move a token across the capacity), forward and step
    apart."""
    cfg = w["tcfg"]
    flips = {}
    for key, route_key, calls in (
            ("moe_in", "troute", moe_calls(w) * 2),
            ("step_moe_in", "step_route", moe_calls(w, step=True))):
        jin, tin = w[key]
        assert len(jin) == len(tin) == len(w[route_key]) == len(calls), \
            (key, len(jin), len(tin), len(calls))
        for x, t, route, (rw, cap) in zip(jin, tin, w[route_key], calls):
            np.testing.assert_array_equal(
                route[3], jax_routing(t, rw, cfg.experts_per_token, cap),
                err_msg=key)
            if bitwise_inputs:
                np.testing.assert_array_equal(t, x, err_msg=key)
            flips[key] = flips.get(key, 0) + (not np.array_equal(
                route[3], jax_routing(x, rw, cfg.experts_per_token, cap)))
    return flips["moe_in"], flips["step_moe_in"]


def check_step(w, grad_max=3e-2, grad_median=None):
    """The train step at the published numerics: the loss within 1e-4;
    each gradient leaf (banks, bank gammas and routers included) within
    ``grad_max`` relative L2 (and the median leaf within
    ``grad_median``); a finite gradient norm; each parameter moved as the
    reference's moved: Adam's first step moves an entry by about ``lr *
    sign(g)``, so wherever the reference's gradient is a quarter of its
    leaf's largest or more (well above the gradients' gap) and its entry
    moved, the port's entry moves the same way, never the other, and
    stays put in at most 1% of them (a bf16 entry whose step is near half
    its spacing may round to no move in one package only); a zero or
    negated gradient fails this.  Every gamma moves.  The int8 state's
    row scales within ``grad_max`` relative L2 (each is a row's largest
    gradient)."""
    jl, tl = w["step_loss"]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert np.isfinite(w["step_grad_norm"])
    jg, tg = w["step_grads"]
    assert sorted(jg) == sorted(tg)
    gaps = {k: rel(tg[k], v) for k, v in jg.items()}
    bad = {k: g for k, g in gaps.items() if not g < grad_max}
    assert not bad, bad
    if grad_median is not None:
        assert np.median(list(gaps.values())) < grad_median, \
            np.median(list(gaps.values()))
    assert any("router" in k for k in gaps) and any(
        k.endswith("w_gate/gamma") and "shared" not in k for k in gaps)
    jp, tp = w["step_params"]
    start = w["step_start"]
    held = set()
    for k, v in jp.items():
        jd, td = np.sign(v - start[k]), np.sign(tp[k] - start[k])
        big = (np.abs(jg[k]) >= 0.25 * np.abs(jg[k]).max()) & (jd != 0)
        assert not (td[big] == -jd[big]).any(), k
        assert (td[big] == 0).sum() <= 0.01 * big.sum(), \
            (k, (td[big] == 0).sum(), big.sum())
        if big.any():
            held.add(k)
        if k.endswith("gamma"):     # the search's logits learn
            assert not np.array_equal(tp[k], start[k]), k
    assert len(held) > len(jp) // 2, sorted(set(jp) - held)
    js, ts = w["step_state"]
    for k, v in js.items():
        if k.endswith(("mq", "vq")):
            assert ts[k].dtype == np.int8 and ts[k].shape == v.shape, k
        else:
            assert rel(ts[k], v) < grad_max, (k, rel(ts[k], v))


def check_plan(w):
    """``extract_plan`` from the same redrawn gammas: group names equal,
    no expert bank and no router among them, the bits and permutations
    equal; ``serve_weight_groups`` gives each group its (C_out, C_in)."""
    jcfg, tcfg = w["jcfg"], w["tcfg"]
    rng = np.random.default_rng(4)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, x: rng.normal(size=x.shape).astype(np.float32)
        if path[-1].key == "gamma" else x, w["tree"])
    jplan = jlm.extract_plan(jcfg, jax.tree.map(jnp.asarray, tree))
    tplan = tlm.extract_plan(tcfg, lm_params_from_jax(tree, cfg=tcfg))
    assert tplan.groups == jplan.groups and tplan.meta == jplan.meta
    assert not any(g.split(".")[3] in ("router", "w_gate", "w_up", "w_down")
                   and g.split(".")[2] == "ffn" and _is_moe_slot(tcfg, g)
                   for g in tplan.groups), tplan.groups
    for g in jplan.groups:
        np.testing.assert_array_equal(tplan.channel_bits[g],
                                      jplan.channel_bits[g])
        np.testing.assert_array_equal(tplan.permutations[g],
                                      jplan.permutations[g])
    groups = tlm.serve_weight_groups(tcfg, lm_params_from_jax(tree,
                                                              cfg=tcfg))
    assert list(groups) == list(tplan.groups)
    return tplan


def _is_moe_slot(cfg, group):
    slot = int(group.split(".")[1][1:])
    return tlm.block_pattern(cfg)[slot].ffn == "moe" and \
        group.split(".")[3] != "shared"
