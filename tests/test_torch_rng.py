"""The port's threefry2x32 generator (``repro_torch.core.rng``) against
``jax.random`` on the CPU, and device sampling with temperature > 0
against the JAX package's ``InferenceServer`` on the ``test_serve``
workload (``llama3.2-1b-smoke``, prompts of 6/14/9/21 tokens).

Tolerances: keys, raw bits, ``uniform``, ``randint`` and ``bernoulli``
are bit-exact.  ``normal`` agrees within 4 ULPs (XLA's ``erf_inv``
polynomial is mirrored, its ``log1p`` is not); ``gumbel`` within 8 ULPs
of ``max(|g|, 1)`` (``-log(-log(u))`` with torch's ``log``, an absolute
error of a few 1e-7 that a ULP count near g = 0 would exaggerate)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro.configs import registry
from repro.models import lm as jlm
from repro.serve import engine as jeng
from repro.serve.sampling import SamplingParams as JSP
from repro.serve.scheduler import Request as JReq
from repro_torch.bridge import params_from_jax
from repro_torch.core import rng
from repro_torch.serve import engine as teng
from repro_torch.serve.sampling import SamplingParams as TSP
from repro_torch.serve.scheduler import Request as TReq
from torch_threads import _one_torch_thread  # noqa: F401

SEEDS = (0, 1, 7, 123456789, 2 ** 31 - 1)


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split_bits_exact(seed):
    jk, tk = jax.random.key(seed), rng.key(seed)
    np.testing.assert_array_equal(_kd(jk), tk.numpy())
    for d in (0, 1, 5, 1_000_000, 2 ** 32 - 1):
        np.testing.assert_array_equal(_kd(jax.random.fold_in(jk, d)),
                                      rng.fold_in(tk, d).numpy())
    for n in (2, 3, 5):
        np.testing.assert_array_equal(_kd(jax.random.split(jk, n)),
                                      rng.split(tk, n).numpy())
    for shape in ((7,), (3, 7), (2, 3, 5)):
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        np.testing.assert_array_equal(want.astype(np.int64),
                                      rng.random_bits(tk, shape).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_randint_bernoulli_exact(seed):
    jk, tk = jax.random.key(seed), rng.key(seed)
    for lo, hi in ((0.0, 1.0), (-2.5, 3.0), (1e-3, 7.0)):
        want = np.asarray(jax.random.uniform(jk, (2000,), minval=lo,
                                             maxval=hi))
        got = rng.uniform(tk, (2000,), lo, hi).numpy()
        np.testing.assert_array_equal(want.view(np.int32),
                                      got.view(np.int32))
    for lo, hi in ((0, 10), (-2, 3), (0, 200), (5, 5), (0, 2 ** 31 - 1)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(jk, (500,), lo, hi)),
            rng.randint(tk, (500,), lo, hi).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.bernoulli(jk, 0.3, (1000,))),
        rng.bernoulli(tk, 0.3, (1000,)).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_and_gumbel_within_ulps(seed):
    jk, tk = jax.random.key(seed), rng.key(seed)
    n = 100_000
    jn = np.asarray(jax.random.normal(jk, (n,)))
    tn = rng.normal(tk, (n,)).numpy()
    assert _ulps(jn, tn).max() <= 4
    jg = np.asarray(jax.random.gumbel(jk, (n,)))
    tg = rng.gumbel(tk, (n,)).numpy()
    ulp1 = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    assert (np.abs(jg - tg) / ulp1).max() <= 8
    # batched keys draw each key's own stream
    keys = jax.random.split(jk, 3)
    tkeys = rng.split(tk, 3)
    np.testing.assert_array_equal(
        np.stack([np.asarray(jax.random.uniform(k, (9,))) for k in keys]),
        rng.uniform(tkeys, (9,)).numpy())


LENS = (6, 14, 9, 21)
KW = dict(max_len=48, max_batch=2, cache="paged", page_size=8)
SAMPLED = (dict(temperature=0.8, max_tokens=12, seed=11),
           dict(temperature=0.7, top_k=12, max_tokens=12, seed=3))


@pytest.fixture(scope="module")
def world():
    cfg = registry.get("llama3.2-1b-smoke")
    jp = jlm.init_params(cfg, jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    r = np.random.default_rng(0)
    prompts = [r.integers(0, cfg.vocab, size=s).astype(np.int32)
               for s in LENS]
    ref = []
    for sp in SAMPLED:
        srv = jeng.InferenceServer(cfg, jp, sample_on_device=True, **KW)
        ref.append(srv.serve([JReq(uid=i, prompt=prompts[i],
                                   sampling=JSP(**sp))
                              for i in range(len(LENS))]))
    return cfg, tp, prompts, ref


def _serve(cfg, tp, prompts, sp, uids=None, **extra):
    srv = teng.InferenceServer(cfg, tp, device="cpu", sample_on_device=True,
                               **{**KW, **extra})
    uids = range(len(prompts)) if uids is None else uids
    out = srv.serve([TReq(uid=i, prompt=prompts[i], sampling=TSP(**sp))
                     for i in uids])
    return out, srv


@pytest.mark.parametrize("which", [0, 1], ids=["temperature", "top_k"])
def test_device_sampled_streams_equal_jax(world, which):
    cfg, tp, prompts, ref = world
    out, _ = _serve(cfg, tp, prompts, SAMPLED[which])
    for i in range(len(LENS)):
        np.testing.assert_array_equal(out[i], ref[which][i])


@pytest.mark.parametrize("which", [0, 1], ids=["temperature", "top_k"])
def test_device_sampling_batched_solo_preempted(world, which):
    """Batched == solo and preempted == uninterrupted with sampling."""
    cfg, tp, prompts, _ = world
    sp = SAMPLED[which]
    full, _ = _serve(cfg, tp, prompts, sp)
    pre, tiny = _serve(cfg, tp, prompts, sp, pages=6)
    assert tiny.stats["preemptions"] > 0
    for i in range(len(LENS)):
        solo, _ = _serve(cfg, tp, prompts, sp, uids=[i])
        np.testing.assert_array_equal(solo[i], full[i])
        np.testing.assert_array_equal(pre[i], full[i])
