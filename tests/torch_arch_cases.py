"""The per-arch cases of the port's serving stack against the JAX
package's on the other dense smoke archs (``test_torch_arch_gemma2.py``,
``test_torch_arch_qwen3.py``, ``test_torch_arch_minicpm.py``; each binds
:func:`arch_world` to its arch and star-imports the cases, so an arch's
cases are one file: one unit of work under ``pytest-xdist --dist
loadfile``), each for its own attention feature:

* ``gemma2-2b-smoke``: local/global layers with a window of 32, the
  attention softcap (50) and the final softcap (30);
* ``qwen3-32b-smoke``: qk-norm;
* ``minicpm-2b-smoke``: multi-head attention.  minicpm-2b has 36 query
  and 36 KV heads; the smoke cut keeps ``min(Hkv, 2)`` KV heads, which
  would make it grouped like llama's smoke, so both packages serve it
  here with ``n_kv_heads = n_heads = 4``.

On the ``test_serve`` workload (prompts of 6/14/9/21 tokens, 12 greedy
tokens each, ``max_len`` 48, ``max_batch`` 2, pages of 8) the port's
dense and paged servers give the JAX package's streams token for token,
float and bound to ``synthetic_plan(bits=None, seed=0)``; prefill plus
decode logits agree within a stated tolerance; and inside the port dense
== paged and batched == solo.  The JAX package runs its planned
projections through K1's plain reference (``torch_parity.jax_k1_plain``,
held bitwise equal to the interpret-mode kernel below).

gemma2's float streams diverged from the JAX package's until the port's
attention softcap took XLA's numbers (``nn/attention.softcap``: the
division by ``cap`` is a multiplication by its float32 reciprocal under
``jax.jit``, and the tanh is XLA's rational approximation).
"""
import dataclasses

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
from repro_torch.serve import engine as teng


def arch_world(arch):
    """The module-scoped ``world`` fixture of one arch (its test ids stay
    ``[<arch>]``): both packages' weights and plans, and the JAX
    package's greedy streams on its dense backend (one compile of the
    decode step; the paged backend compiles one a table width), float and
    plan-bound."""
    @pytest.fixture(scope="module", params=[arch])
    def world(request):
        return _build_world(request.param)
    return world


def _build_world(arch):
    cfg, tcfg = registry.get(arch), treg.get(arch)
    if arch.startswith("minicpm"):            # MHA, as at full width
        cfg = dataclasses.replace(cfg, n_kv_heads=cfg.n_heads)
        tcfg = dataclasses.replace(tcfg, n_kv_heads=tcfg.n_heads)
    jp = jlm.init_params(cfg, jax.random.key(0))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg=tcfg)
    jplan = jeng.synthetic_plan(cfg, jp, bits=None, seed=0)
    plans = {"float": (None, None),
             "plan": (jplan, teng.synthetic_plan(tcfg, tp, bits=None,
                                                 seed=0))}
    bound = {"float": jp, "plan": jeng.apply_plan(cfg, jp, jplan)}
    reqs = dict(enumerate(tp_.prompts(cfg)))
    ref = {mode: tp_.serve_jax(cfg, bound[mode], "dense", reqs)
           for mode in plans}
    return dict(cfg=cfg, tcfg=tcfg, jp=jp, tp=tp, plans=plans, bound=bound,
                reqs=reqs, ref=ref)


def test_arch_features(world):
    """Each arch carries the feature it is here for."""
    cfg = world["tcfg"]
    if cfg.name.startswith("gemma2"):
        assert (cfg.attn_pattern, cfg.local_window, cfg.attn_softcap,
                cfg.final_softcap) == ("local_global", 32, 50.0, 30.0)
    elif cfg.name.startswith("qwen3"):
        assert cfg.qk_norm
    else:
        assert cfg.n_heads == cfg.hkv_eff == 4


@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["float", "plan"])
def test_greedy_streams_equal_jax(world, mode, cache):
    got = tp_.serve_port(world["tcfg"], world["tp"], world["plans"][mode][1],
                         cache, world["reqs"])
    same = tp_.same_streams(got, world["ref"][mode])
    assert all(same.values()), (world["cfg"].name, mode, cache, same)


def test_plans_equal_jax(world):
    jplan, tplan = world["plans"]["plan"]
    assert jplan.groups == tplan.groups
    for g in jplan.groups:
        np.testing.assert_array_equal(jplan.channel_bits[g],
                                      tplan.channel_bits[g])
        np.testing.assert_array_equal(jplan.permutations[g],
                                      tplan.permutations[g])


@pytest.mark.parametrize("mode", ["float", "plan"])
def test_prefill_decode_logits_match_jax(world, mode):
    """A 13-token prefill plus 8 teacher-forced decode steps.  Logits
    agree within ``2e-2 * max|logits|`` (the bound of
    ``test_torch_lm.py``: bf16 compute, and a planned projection's int8
    activation quantization can turn one bf16 ulp into an integer step);
    the port's dense and paged paths are bitwise equal."""
    cfg, tcfg = world["cfg"], world["tcfg"]
    tplan = world["plans"][mode][1]
    jparams = world["bound"][mode]
    tparams = world["tp"] if tplan is None else \
        teng.apply_plan(tcfg, world["tp"], tplan)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(1, 21)).astype(np.int32)
    want = tp_.jax_logits(cfg, jparams, tokens, 13)
    outs = {c: tp_.port_logits(tcfg, tparams, tokens, 13, c)
            for c in ("dense", "paged")}
    tol = 2e-2 * np.abs(want).max()
    for cache, got in outs.items():
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=f"{cfg.name} {mode}/{cache}")
    np.testing.assert_array_equal(outs["dense"], outs["paged"])


@pytest.mark.parametrize("mode", ["float", "plan"])
def test_port_dense_equals_paged_and_batched_equals_solo(world, mode):
    tcfg, tp, reqs = world["tcfg"], world["tp"], world["reqs"]
    plan = world["plans"][mode][1]
    dense = tp_.serve_port(tcfg, tp, plan, "dense", reqs)
    paged = tp_.serve_port(tcfg, tp, plan, "paged", reqs)
    assert all(tp_.same_streams(paged, dense).values())
    for u, p in reqs.items():
        solo = tp_.serve_port(tcfg, tp, plan, "paged", {u: p})
        np.testing.assert_array_equal(solo[u], dense[u])
