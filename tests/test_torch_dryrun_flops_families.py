"""The dry-run's per-rank product FLOPs of the enc-dec, VLM and hybrid
families' smoke cells against the JAX package's ``hlo_analysis`` of the
same cells compiled on a four-device CPU mesh
(``torch_dryrun_cases.flops_views``, as
``tests/test_torch_dryrun_flops.py`` holds the other families'): a (2, 2)
mesh under the arch's ``RULE_OVERRIDES`` and ``shape_rules``, batch 8 x
64 tokens at smoke widths (jamba's ``long_500k`` at batch 1 over 64
positions).

Tolerance 10%; readings: train 1.000 (seamless, qwen2-vl) and 1.024
(jamba), prefill 1.093 / 1.090 / 1.037 (the port projects its own rows'
K/V for every KV head into its cache block beside the flash pass's
local heads), decode 1.053 / 1.067 / 1.036.  jamba's ``long_500k`` cell
reads 1.44, outside it, for the reason scout's long-context cell does
(ROADMAP section 3): ``batch`` is unmapped and ``w_embed`` stays on
``data``, so both data ranks gather each dense projection's weight and
take the whole product, where the JAX partitioner contracts it over the
data-split ``d_model`` and all-reduces.  That cell is held exactly:
the port's FLOPs are the JAX package's plus half of every dense
projection's product a rank (:func:`_repeated`), the expert banks and
the router excepted (both packages' expert-parallel branch runs them
alike)."""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_dryrun_cases as dc
from repro_torch.configs import registry as treg
from repro_torch.models import lm
from torch_threads import _one_torch_thread  # noqa: F401

CELLS = [[a, s, 8, 64, False]
         for a in ("seamless-m4t-medium-smoke", "qwen2-vl-72b-smoke",
                   "jamba-1.5-large-398b-smoke")
         for s in ("train_4k", "prefill_32k", "decode_32k")]
LONG = [["jamba-1.5-large-398b-smoke", "long_500k", 1, 64, False]]
TOL = 0.10


@pytest.fixture(scope="module")
def both():
    return dc.flops_views(CELLS + LONG)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_dot_flops_match_jax_hlo_analysis(both, cell):
    port, jax = both
    key = "|".join(map(str, cell))
    got = port[key]["roofline"]["flops_per_device"]
    want = jax[key]["flops"]
    assert want > 0 and abs(got / want - 1) <= TOL, (got, want)


def _repeated(cfg, tp=2) -> int:
    """Half of every dense projection's product a rank in a one-token
    decode step, ``K * N`` of each weight as the rank multiplies it:
    attention's ``wq`` / ``wo`` on its ``h / tp`` heads and ``wk`` /
    ``wv`` whole (the cache takes every KV head), a Mamba-2 layer's
    ``in_z`` / ``in_x`` / ``out_proj`` on its ``d_inner / tp`` channels,
    ``in_b`` / ``in_c`` whole and ``in_dt`` on its ``H / tp`` heads, a
    dense FFN on its ``d_ff / tp`` columns, and the head on its vocab
    rows."""
    d, hd = cfg.d_model, cfg.head_dim
    per = 0
    for spec in lm.block_pattern(cfg):
        if spec.mixer == "mamba":
            di = cfg.d_inner // tp
            per += 3 * d * di + 2 * d * cfg.ssm_state \
                + d * (cfg.ssm_heads // tp)
        else:
            per += 2 * d * (cfg.h_eff * hd // tp) + 2 * d * cfg.hkv_eff * hd
        if spec.ffn == "dense":
            per += 3 * d * (cfg.d_ff // tp)
    return per * lm.n_superblocks(cfg) + d * lm.padded_vocab(cfg) // tp


@pytest.mark.parametrize("cell", LONG, ids=lambda c: f"{c[0]}-{c[1]}")
def test_long_context_excess_is_the_repeated_projections(both, cell):
    port, jax = both
    key = "|".join(map(str, cell))
    got = port[key]["roofline"]["flops_per_device"]
    want = jax[key]["flops"]
    assert got - want == _repeated(treg.get(cell[0])), (got, want)
