"""The port's search end to end with trained PACT clips, against the JAX
package on the CPU: resnet9 width 4 on CIFAR10_LIKE, batch 8, warmup 2 /
search 3 / finetune 2 steps, pw (0, 2, 4, 8), px (8,), lambda 1e4.

The plans agree on everything but the clips' last bits: bits, Fig. 3
permutations and activation bits are equal, and each trained clip is
within 5e-4 of the reference's (observed: up to ~200 ULPs of 6.0, 1e-4).
A clip's gradient is a sum of many rounding-sized PACT terms, and two
more effects move it: a conv bias ahead of a train-mode BN has a zero
gradient in exact arithmetic and rounding noise in float32, which Adam
turns into a full ``lr`` step of either sign, differently in the two
packages; the folded biases then differ by ~1e-3.  Accuracies agree
within 0.04 (see ``test_torch_search_e2e``).
"""
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from test_torch_search_e2e import run_both  # noqa: E402
from torch_threads import _one_torch_thread  # noqa: F401


def test_search_with_trained_clips_matches_jax():
    jr, tr, jplan = run_both(lambda m: m.resnet9(width=4), "CIFAR10_LIKE",
                             (8,), (2, 3, 2), 1e4)
    clips = dict(tr.plan.alphas)
    for k, v in clips.items():
        assert abs(v - jplan.alphas[k]) <= 5e-4, (k, v, jplan.alphas[k])
    tr.plan.alphas = dict(jplan.alphas)
    assert tr.plan.equals(jplan)
    assert 0 < tr.prune_fraction < 1
    assert tr.bits_histogram == jr.bits_histogram
    assert tr.acc_final == pytest.approx(jr.acc_final, abs=0.04)
