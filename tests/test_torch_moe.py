"""The port's MoE (``nn/blocks.moe_layer``, ``models/lm``, serving) against
the JAX package's on ``llama4-scout-17b-a16e-smoke`` (3 chunked + 1 full
attention layers, 4 experts, top-1, a shared FFN) and ``arctic-480b-smoke``
(full attention, 4 experts, top-2, a shared FFN).

* ``_moe_local``: the experts each token picks and the tokens each expert
  keeps equal the reference's (ties to the lower index, an over-full
  expert dropping, a short one filled with zero-gate tokens), and the
  output agrees.
* Prefill plus decode logits, and the ``test_serve`` workload's greedy
  streams (prompts of 6/14/9/21 tokens, 12 tokens, ``max_len`` 48,
  ``max_batch`` 4, pages of 8), float and plan-bound: port-dense against
  JAX-dense and port-paged against JAX-paged.
* Plan groups, bits and permutations.

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

import torch_parity as tp_
from repro.configs import registry
from repro.models import lm as jlm
from repro.nn import blocks as jblocks
from repro.serve import engine as jeng
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import registry as treg
from repro_torch.models import lm as tlm
from repro_torch.nn import blocks as tblocks
from repro_torch.serve import engine as teng

ARCHS = ("llama4-scout-17b-a16e-smoke", "arctic-480b-smoke")
MAX_BATCH = 4


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


# ---------------------------------------------------------------------------
# the model and the server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def world(request):
    """One arch: both packages' weights and plans, and the JAX package's
    greedy streams on each backend, float and plan-bound."""
    cfg, tcfg = registry.get(request.param), treg.get(request.param)
    jp = jlm.init_params(cfg, jax.random.key(0))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg=tcfg)
    jplan = jeng.synthetic_plan(cfg, jp, bits=None, seed=0)
    plans = {"float": None,
             "plan": teng.synthetic_plan(tcfg, tp, bits=None, seed=0)}
    bound = {"float": jp, "plan": jeng.apply_plan(cfg, jp, jplan)}
    reqs = dict(enumerate(tp_.prompts(cfg)))
    ref = {(mode, cache): tp_.serve_jax(cfg, bound[mode], cache, reqs,
                                        max_batch=MAX_BATCH)
           for mode in plans for cache in ("dense", "paged")}
    return dict(cfg=cfg, tcfg=tcfg, jp=jp, tp=tp, jplan=jplan, plans=plans,
                bound=bound, reqs=reqs, ref=ref)


def test_tree_matches_jax(world):
    """The port builds the reference's tree: the same paths and shapes,
    with the search's gammas (one per expert bank, shared by its
    experts) and without; the bridge takes the JAX tree."""
    cfg, tcfg = world["cfg"], world["tcfg"]
    for mps_on in (False, True):
        jt = jax.tree_util.tree_flatten_with_path(
            jlm.abstract_params(cfg, mps_on=mps_on))[0]
        want = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in jt}
        got = {}

        def walk(t, path):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{path}['{k}']")
            else:
                got[path] = tuple(t.shape)

        walk(tlm.init_params(tcfg, device="cpu", mps_on=mps_on), "")
        assert got == want
    assert tlm.mps_param_count(tcfg) == jlm.mps_param_count(cfg)
    bank = world["tp"]["blocks"]["l0"]["ffn"]["w_gate"]["w"]
    assert bank.shape == (tlm.n_superblocks(tcfg), tcfg.n_experts,
                          tcfg.d_model, tcfg.expert_d_ff)


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


def test_bridge_rejects_a_bank_without_its_expert_axis(world):
    tree = jax.tree.map(np.asarray, world["jp"])
    ffn = tree["blocks"]["l0"]["ffn"]
    ffn["w_up"]["w"] = ffn["w_up"]["w"][:, 0]           # (nsb, K, N)
    with pytest.raises(ValueError, match="expert bank"):
        lm_params_from_jax(tree, cfg=world["tcfg"])


def test_plans_equal_jax(world):
    jplan, tplan = world["jplan"], world["plans"]["plan"]
    assert jplan.groups == tplan.groups
    assert any(".ffn.shared." in g for g in tplan.groups)
    assert not any("router" in g or ".ffn.w_" in g for g in tplan.groups)
    for g in jplan.groups:
        np.testing.assert_array_equal(jplan.channel_bits[g],
                                      tplan.channel_bits[g])
        np.testing.assert_array_equal(jplan.permutations[g],
                                      tplan.permutations[g])


def test_apply_plan_keeps_router_and_banks_float(world):
    tcfg = world["tcfg"]
    bound = teng.apply_plan(tcfg, world["tp"], world["plans"]["plan"])
    assert len(bound["blocks"]) == tlm.n_superblocks(tcfg)
    ffn = bound["blocks"][0]["l0"]["ffn"]
    assert isinstance(ffn["router"]["w"], torch.Tensor)
    assert ffn["w_down"]["w"].shape == (tcfg.n_experts, tcfg.expert_d_ff,
                                        tcfg.d_model)
    assert "gamma" not in ffn["w_gate"]
    assert type(ffn["shared"]["w_up"]["w"]).__name__ == "PackedLinear"


@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["float", "plan"])
def test_greedy_streams_equal_jax_per_backend(world, mode, cache):
    got = tp_.serve_port(world["tcfg"], world["tp"], world["plans"][mode],
                         cache, world["reqs"], max_batch=MAX_BATCH)
    same = tp_.same_streams(got, world["ref"][(mode, cache)])
    assert all(same.values()), (world["cfg"].name, mode, cache, same)


def test_reference_dense_and_paged_streams_differ(world):
    """The exemption, measured: with max_batch 4 the JAX package's dense
    and paged servers give different MoE streams (idle decode rows and
    a paged prompt's padding take capacity), float and plan-bound, so
    neither package holds dense == paged for MoE."""
    ref = world["ref"]
    for mode in ("float", "plan"):
        same = tp_.same_streams(ref[(mode, "paged")], ref[(mode, "dense")])
        assert not all(same.values()), (world["cfg"].name, mode, same)


@pytest.mark.parametrize("mode", ["float", "plan"])
def test_prefill_decode_logits_match_jax(world, mode):
    """A 16-token prefill (a page multiple: the paged prefill then pads
    nothing and sees the dense capacity) plus 8 teacher-forced decode
    steps of 2 rows.  Logits agree within ``2e-2 * max|logits|`` (the
    bound of ``test_torch_lm.py``); both backends were bitwise equal to
    the JAX package's when measured."""
    cfg, tcfg = world["cfg"], world["tcfg"]
    tplan = world["plans"][mode]
    tparams = world["tp"] if tplan is None else \
        teng.apply_plan(tcfg, world["tp"], tplan)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(2, 24)).astype(np.int32)
    want = tp_.jax_logits(cfg, world["bound"][mode], tokens, 16)
    tol = 2e-2 * np.abs(want).max()
    for cache in ("dense", "paged"):
        got = tp_.port_logits(tcfg, tparams, tokens, 16, cache)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=f"{cfg.name} {mode}/{cache}")


def test_training_an_moe_stack_raises():
    cfg = treg.get("arctic-480b-smoke")
    params = tlm.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="slice E"):
        tlm.forward(cfg, params, {"tokens": torch.zeros((1, 8),
                                                        dtype=torch.int32)},
                    mode="train")
