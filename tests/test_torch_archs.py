"""The pieces of the port's dense-arch serving held bitwise against the
JAX package's: the attention softcap under ``jax.jit`` (gemma2's float
streams diverged from the JAX package's until the port's softcap took
XLA's numbers: the division by ``cap`` is a multiplication by its
float32 reciprocal under ``jax.jit``, and the tanh is XLA's rational
approximation), and the swap ``torch_parity.jax_k1_plain`` makes.

The per-arch serving cases (gemma2, qwen3, minicpm) are
``torch_arch_cases.py``'s, run by ``test_torch_arch_<arch>.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_parity as tp_
from repro.kernels.quant_matmul import ops as jqops
from repro.kernels.quant_matmul import ref as jqref
from repro.nn import blocks as jblocks
from repro_torch.nn import attention as tattn
from torch_threads import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("cap", [50.0, 30.0])
def test_attention_softcap_bitwise_under_jit(cap):
    """float32 scores through the port's softcap equal ``blocks.softcap``
    under ``jax.jit`` bit for bit, clamp, tiny and infinite values
    included (it differed in ~55% of values before: torch's division and
    libm's tanh); bf16 logits (the final softcap) too."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        (rng.standard_normal(200_000) * 40).astype(np.float32),
        (rng.standard_normal(20_000) * 1e-2).astype(np.float32),
        np.array([0.0, -0.0, 3e-4, 4e-4, 7.99 * cap, 8 * cap, 9 * cap,
                  1e30, -1e30, np.inf, -np.inf], np.float32)])
    want = np.asarray(jax.jit(lambda v: jblocks.softcap(v, cap))(x))
    got = tattn.softcap(torch.from_numpy(x), cap).numpy()
    np.testing.assert_array_equal(got, want)
    xb = jnp.asarray(x[:50_000], jnp.bfloat16)
    want_b = np.asarray(jax.jit(lambda v: jblocks.softcap(v, cap))(xb)
                        .astype(jnp.float32))
    got_b = tattn.softcap(torch.from_numpy(np.asarray(
        xb.astype(jnp.float32))).bfloat16(), cap).float().numpy()
    np.testing.assert_array_equal(got_b, want_b)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_jax_k1_plain_equals_interpret_kernel(bits):
    """The swap ``torch_parity.jax_k1_plain`` makes is exact at the smoke
    widths: K1's plain reference equals the interpret-mode kernel bitwise
    at a decode and a prefill row count, K = 64 and 128."""
    rng = np.random.default_rng(bits)
    qmax = 2 ** (bits - 1) - 1
    for m, k, n in ((2, 64, 40), (24, 128, 64)):
        xq = jnp.asarray(rng.integers(-127, 128, (m, k)), jnp.int8)
        wq = rng.integers(-qmax - 1, qmax + 1, (n, k)).astype(np.int8)
        wp = jnp.asarray(jqref.pack_weights(wq, bits))
        sw = jnp.asarray(rng.random(n) * 1e-2, jnp.float32)
        one = jnp.asarray(1.0, jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(tp_.quant_matmul_plain(xq, wp, sw, one, w_bits=bits)),
            np.asarray(jqops.quant_matmul(xq, wp, sw, one, w_bits=bits)))
