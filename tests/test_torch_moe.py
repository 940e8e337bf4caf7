"""The port's MoE (``nn/blocks.moe_layer``, ``models/lm``, serving) against
the JAX package's on ``llama4-scout-17b-a16e-smoke`` (3 chunked + 1 full
attention layers, 4 experts, top-1, a shared FFN) and ``arctic-480b-smoke``
(full attention, 4 experts, top-2, a shared FFN).

* ``_moe_local``: the experts each token picks and the tokens each expert
  keeps equal the reference's (ties to the lower index, an over-full
  expert dropping, a short one filled with zero-gate tokens), and the
  output agrees.
* The count of the search's gammas, from the meta-device tree.
* The model and server cases run once per arch, in
  ``test_torch_moe_scout.py`` and ``test_torch_moe_arctic.py``
  (``torch_moe_cases.py``): prefill plus decode logits, greedy streams
  per backend, plan groups, bits and permutations.

Capacity counts every row of a step, so an MoE stream depends on what
else is in the batch and on the padding of a paged prefill: the JAX
package's own dense and paged streams differ, and the port is not held
to dense == paged or batched == solo here
(``test_reference_dense_and_paged_streams_differ``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro.configs import registry
from repro.models import lm as jlm
from repro.nn import blocks as jblocks
from repro_torch.configs import registry as treg
from repro_torch.models import lm as tlm
from repro_torch.nn import blocks as tblocks
from torch_threads import _one_torch_thread  # noqa: F401

ARCHS = ("llama4-scout-17b-a16e-smoke", "arctic-480b-smoke")


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def _jax_route(x, router_w, k, cap):
    """The selections ``blocks._moe_local`` makes, op for op."""
    logits = x @ router_w
    probs = jax.nn.softmax(logits, axis=-1)
    gates, ids = jax.lax.top_k(probs, k)
    top = [jax.lax.top_k(jnp.sum(gates * (ids == e), axis=-1),
                         min(cap, x.shape[0]))
           for e in range(router_w.shape[1])]
    return (gates, ids, jnp.stack([g for g, _ in top]),
            jnp.stack([i for _, i in top]))


def _layer_case(kind, seed=0, t=24, d=64, e=4, f=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) / 8).astype(np.float32)
    if kind == "tied":          # experts 1 and 2 score every token alike
        router[:, 2] = router[:, 1]
    elif kind == "overfull":    # every token prefers expert 0
        x += 0.5
        router[:, 0] += 0.5
    banks = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
             for s in ((e, d, f), (e, d, f), (e, f, d))]
    return x, router, banks


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("kind", ["random", "tied", "overfull"])
def test_moe_local_selections_and_output_match_jax(kind, top_k):
    """Expert ids and each expert's kept tokens are equal; gates and the
    output are bitwise on these cases, held within one bf16 step of the
    output's scale (2^-7 max|y|)."""
    x, router, banks = _layer_case(kind, seed=top_k)
    t, e = x.shape[0], router.shape[1]
    cap = max(1, math.ceil(t * top_k * 1.25 / e))
    xj = jnp.asarray(x, jnp.bfloat16)
    bj = [jnp.asarray(b, jnp.bfloat16) for b in banks]
    want = [np.asarray(a) for a in jax.jit(
        lambda xx, r: _jax_route(xx, r, top_k, cap))(xj, router)]
    yj = np.asarray(jax.jit(lambda xx, r, g, u, dn: jblocks._moe_local(
        xx, r, g, u, dn, n_experts=e, top_k=top_k, capacity=cap,
        e_offset=0))(xj, router, *bj).astype(jnp.float32))

    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).bfloat16()
    bt = [torch.from_numpy(np.asarray(b.astype(jnp.float32))).bfloat16()
          for b in bj]
    rt = torch.from_numpy(router)
    got = [a.numpy() for a in tblocks.moe_route(xt, rt, top_k=top_k,
                                                capacity=cap)]
    yt = tblocks._moe_local(xt, rt, *bt, top_k=top_k,
                            capacity=cap).float().numpy()

    np.testing.assert_array_equal(got[1], want[1])          # expert ids
    np.testing.assert_array_equal(got[3], want[3])          # kept tokens
    np.testing.assert_array_equal(got[0], want[0])          # gates
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(yt, yj, rtol=0,
                               atol=2.0 ** -7 * np.abs(yj).max())
    counts = np.bincount(want[1].reshape(-1), minlength=e)
    if kind == "overfull":
        assert counts.max() > cap        # the preferred expert drops some
    if kind == "tied":
        assert not np.any(want[1] == 2) or top_k == 2


@pytest.mark.parametrize("t,k,n", [(1, 64, 4), (24, 64, 4), (8, 64, 16),
                                   (48, 2048, 16), (200, 64, 8),
                                   (3, 100, 7)])
def test_router_dot_bitwise_under_jit(t, k, n):
    """``xla_numerics.dot_f32`` gives XLA's float32 ``x @ w`` bit for bit
    inside its envelope (K <= 2048, N <= 16; the smoke routers are
    K = 64, N = 4); ``torch.matmul`` sums most of these in other orders."""
    from repro_torch.nn import xla_numerics
    rng = np.random.default_rng(t * k + n)
    x = rng.standard_normal((t, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: a @ b)(x, w))
    got = xla_numerics.dot_f32(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)


def test_capacity_counts_every_row():
    """``moe_layer``'s capacity is ``ceil(B * S * k * 1.25 / E)`` over
    the whole batch: the same token keeps or loses its expert with the
    other rows."""
    cfg = treg.get("llama4-scout-17b-a16e-smoke")
    seen = []
    route = tblocks.moe_route

    def spy(x, w, *, top_k, capacity):
        seen.append((x.shape[0], capacity))
        return route(x, w, top_k=top_k, capacity=capacity)

    params = tlm.init_params(cfg, device="cpu")
    p = tlm._index(params["blocks"]["l0"]["ffn"], 0)
    tblocks.moe_route = spy
    try:
        for b, s in ((1, 8), (4, 1), (1, 24), (3, 7)):
            tblocks.moe_layer(p, torch.zeros((b, s, cfg.d_model),
                                             dtype=torch.bfloat16), cfg,
                              effective_w=lambda pp: pp["w"].bfloat16())
    finally:
        tblocks.moe_route = route
    assert seen == [(8, 3), (4, 2), (24, 8), (21, 7)]


@pytest.mark.parametrize("arch", ARCHS + ("llama4-scout-17b-a16e",
                                          "arctic-480b"))
def test_gamma_count_from_the_meta_tree(arch):
    """``mps_param_count`` counts the gammas of ``init_params``' tree on
    the meta device (shapes, no numbers; cheap at full width) and gives
    the JAX package's count."""
    tcfg = treg.get(arch)
    tree = tlm.init_params(tcfg, device="meta", mps_on=True)
    devices = set()

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            devices.add(t.device.type)

    walk(tree)
    assert devices == {"meta"}
    assert tlm.mps_param_count(tcfg) == jlm.mps_param_count(
        registry.get(arch))


def test_training_an_moe_stack_runs():
    """An MoE stack trains (the refusal that named slice E is gone):
    the train-mode forward gives finite logits, and under the search the
    loss's gradient reaches every expert bank, its one shared gamma and
    the router (parity with the JAX package: ``test_torch_moe_train.py``)."""
    from repro_torch.core import mps as tmps
    cfg = treg.get("arctic-480b-smoke")
    params = tlm.init_params(cfg, device="cpu", mps_on=True)
    tok = torch.zeros((1, 8), dtype=torch.int32)
    logits, caches = tlm.forward(cfg, params, {"tokens": tok}, mode="train")
    assert caches is None and torch.isfinite(logits).all()
    leaves = {k: v.requires_grad_() for k, v in (
        ("router", params["blocks"]["l0"]["ffn"]["router"]["w"]),
        ("bank", params["blocks"]["l0"]["ffn"]["w_down"]["w"]),
        ("gamma", params["blocks"]["l0"]["ffn"]["w_down"]["gamma"]))}
    loss = tlm.loss_fn(cfg, params, {"tokens": tok, "targets": tok},
                       ctx=tmps.SearchCtx(tau=1.0), lam=1e-6)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for name, g in zip(leaves, grads):
        assert torch.isfinite(g).all() and g.abs().sum() > 0, name
