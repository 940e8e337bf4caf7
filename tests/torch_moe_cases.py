"""The per-arch cases of the port's MoE against the JAX package's
(``test_torch_moe_scout.py``, ``test_torch_moe_arctic.py``; the layer
cases are in ``test_torch_moe.py``).  Each per-arch file binds
:func:`arch_world` to its arch and star-imports the cases, so an arch's
cases are one file: one unit of work under ``pytest-xdist --dist
loadfile``.

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
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_parity as tp_
from repro.configs import registry
from repro.models import lm as jlm
from repro.serve import engine as jeng
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import registry as treg
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as teng

MAX_BATCH = 4


# ---------------------------------------------------------------------------
# the model and the server
# ---------------------------------------------------------------------------

def arch_world(arch):
    """The module-scoped ``world`` fixture of one arch (its test ids stay
    ``[<arch>]``): both packages' weights and plans, and the JAX
    package's greedy streams on each backend, float and plan-bound."""
    @pytest.fixture(scope="module", params=[arch])
    def world(request):
        return _build_world(request.param)
    return world


def _build_world(arch):
    cfg, tcfg = registry.get(arch), treg.get(arch)
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
