"""The dry-run's per-rank product FLOPs (``cost_analysis``, one traced
step on rank 0 of a fake group of four ranks) against the JAX package's
``hlo_analysis.analyze`` of the same small cell compiled on a
four-device CPU mesh (``torch_dryrun_jax.py``), both on a (2, 2) mesh
under the arch's ``RULE_OVERRIDES`` and ``shape_rules``, batch 8 x 64
tokens at smoke widths.

Tolerance 10% (the ROADMAP's threshold for a logged gap); readings:
train (with and without the search) 1.000 on llama and 1.032 on mamba,
prefill 1.090 (llama: the port projects its own rows' K/V for every KV
head into its cache block beside the flash pass's local heads), 1.056
(mamba) and 1.054 (arctic), decode 1.067 / 1.044 / 1.041.  The
long-context decode cell lies outside it (scout 1.31 at 64 positions,
1.18 at 1024): the JAX partitioner contracts each projection over the
data-split ``d_model`` where the port gathers the weight and repeats
the projection on both data ranks (ROADMAP section 3).  The enc-dec,
VLM and hybrid families' cells are
``tests/test_torch_dryrun_flops_families.py``."""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_dryrun_cases as dc
from torch_threads import _one_torch_thread  # noqa: F401

CELLS = [["llama3.2-1b-smoke", "train_4k", 8, 64, False],
         ["llama3.2-1b-smoke", "train_4k", 8, 64, True],
         ["llama3.2-1b-smoke", "prefill_32k", 8, 64, False],
         ["llama3.2-1b-smoke", "decode_32k", 8, 64, False],
         ["mamba2-780m-smoke", "train_4k", 8, 64, False],
         ["mamba2-780m-smoke", "prefill_32k", 8, 64, False],
         ["mamba2-780m-smoke", "decode_32k", 8, 64, False],
         ["arctic-480b-smoke", "prefill_32k", 8, 64, False],
         ["arctic-480b-smoke", "decode_32k", 8, 64, False]]
TOL = 0.10


@pytest.fixture(scope="module")
def both():
    return dc.flops_views(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}"
                         f"{'-search' if c[4] else ''}")
def test_dot_flops_match_jax_hlo_analysis(both, cell):
    port, jax = both
    key = "|".join(map(str, cell))
    got = port[key]["roofline"]["flops_per_device"]
    want = jax[key]["flops"]
    assert want > 0 and abs(got / want - 1) <= TOL, (got, want)
