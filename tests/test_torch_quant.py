"""The port's deployment math against the JAX package on the CPU: packed
buffers, scales and ``out_index`` byte-identical; the int32 plain product
equal to JAX ``ops.quant_matmul`` (interpret mode); plans loading field
for field across the two packages."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro.api.plan import CompressionPlan as JPlan
from repro.core import quantizers as jquant
from repro.kernels.quant_matmul import ops as jqops
from repro.nn import quantized as jq
from repro_torch.api.plan import CompressionPlan as TPlan
from repro_torch.core import quantizers as tquant
from repro_torch.kernels.quant_matmul import ops as tqops
from repro_torch.kernels.quant_matmul import ref as tqref
from repro_torch.nn import quantized as tq
from torch_threads import _one_torch_thread  # noqa: F401

N_IN, N_OUT = 37, 24     # ragged: 37 is no multiple of 4 (2-bit) or 2


def _bits(kind, rng):
    return {"w8": np.full(N_OUT, 8), "w4": np.full(N_OUT, 4),
            "w2": np.full(N_OUT, 2),
            "mixed": rng.choice([2, 4, 8], size=N_OUT),
            "pruned": rng.choice([0, 0, 2, 4, 8], size=N_OUT),
            "all_pruned": np.zeros(N_OUT, np.int64)}[kind]


@pytest.mark.parametrize("kind", ["w8", "w4", "w2", "mixed", "pruned",
                                  "all_pruned"])
def test_packed_linear_byte_identical(kind):
    rng = np.random.default_rng(len(kind))
    w = rng.normal(size=(N_IN, N_OUT)).astype(np.float32)
    bits = _bits(kind, rng)
    a = jq.PackedLinear.from_dense(w, bits)
    b = tq.PackedLinear.from_dense(torch.as_tensor(w), bits)
    assert tuple(int(g[0]) for g in a.groups) == b.bits
    for (_, wa, sa), (_, wb, sb) in zip(a.groups, b.groups):
        assert np.asarray(wa).tobytes() == wb.numpy().tobytes()
        assert np.asarray(sa).tobytes() == sb.numpy().tobytes()
    assert np.asarray(a.out_index).tobytes() == b.out_index.numpy().tobytes()
    assert b.kept == a.kept
    x = rng.normal(size=(5, N_IN)).astype(np.float32)
    ya = np.asarray(a(jnp.asarray(x)))
    yb = b(torch.as_tensor(x)).numpy()
    # same integers, same f32 epilogue: measured max |diff| 0; the
    # tolerance is one f32 rounding of the per-row activation scale
    np.testing.assert_allclose(yb, ya, rtol=1e-6, atol=1e-6)
    if kind == "all_pruned":
        assert b.kept == 0 and not b.bits and not yb.any()


def test_integerize_weights_byte_identical():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(16, 33)).astype(np.float32)
    w[3] = 0.0                                   # all-zero channel: eps
    for bits in (0, 2, 4, 8):
        qa, sa = jquant.integerize_weights(jnp.asarray(w), bits, 0)
        qb, sb = tquant.integerize_weights(torch.as_tensor(w), bits, 0)
        assert np.asarray(qa).tobytes() == qb.numpy().tobytes()
        assert np.asarray(sa).tobytes() == sb.numpy().tobytes()


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("m", [1, 4, 13])
def test_quant_matmul_ref_equals_jax(bits, m):
    """The port's int32 plain product equals JAX ``ops.quant_matmul``
    (Pallas interpret mode) exactly; N and K are ragged."""
    rng = np.random.default_rng(bits * 100 + m)
    n, k = 45, 70
    per = 8 // bits
    kp = -(-k // per) * per
    qmax = 2 ** (bits - 1) - 1
    xq = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    wq = np.zeros((n, kp), np.int8)
    wq[:, :k] = rng.integers(-qmax, qmax + 1, size=(n, k))
    sw = rng.uniform(0.001, 0.01, size=n).astype(np.float32)
    packed = jqops.pack_weights(wq, bits)
    assert tqref.pack_weights(torch.as_tensor(wq), bits).numpy().tobytes() \
        == packed.tobytes()
    want = np.asarray(jqops.quant_matmul(
        jnp.asarray(xq), jnp.asarray(packed), jnp.asarray(sw),
        jnp.asarray(0.5, jnp.float32), w_bits=bits))
    got = tqops.quant_matmul(torch.as_tensor(xq), torch.as_tensor(packed),
                             torch.as_tensor(sw), torch.tensor(0.5),
                             w_bits=bits)
    assert got.numpy().tobytes() == want.tobytes()


def test_mixed_precision_matmul_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(N_OUT, N_IN)).astype(np.float32)
    bits = _bits("pruned", rng)
    pa, perm_a, kept_a = jq.pack_channelwise(w, bits)
    pb, perm_b, kept_b = tq.pack_channelwise(torch.as_tensor(w), bits)
    assert np.array_equal(perm_a, perm_b) and kept_a == kept_b
    x = rng.normal(size=(6, N_IN)).astype(np.float32)
    ya = np.asarray(jq.mixed_precision_matmul(jnp.asarray(x), pa))
    yb = tq.mixed_precision_matmul(torch.as_tensor(x), pb).numpy()
    np.testing.assert_allclose(yb, ya, rtol=1e-6, atol=1e-6)
    assert tq.mixed_precision_matmul(torch.as_tensor(x), []).shape == (6, 0)


def _plan_fields(p):
    return (p.pw, p.px, p.act_bits, p.alphas, p.meta, p.groups,
            {g: (p.channel_bits[g].tolist(), p.permutations[g].tolist())
             for g in p.groups}, p.sublayer_split(), p.summary())


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_plan_files_cross_load(tmp_path, direction):
    rng = np.random.default_rng(4)
    assignment = {"gamma": {f"g{i}": rng.choice([0, 2, 4, 8], size=12)
                            for i in range(3)},
                  "delta": {"n0": 8}, "alpha": {"n0": 1.5}}
    meta = {"arch": "llama3.2-1b-smoke", "seed": 0}
    src_cls, dst_cls = (JPlan, TPlan) if direction == "jax_to_torch" \
        else (TPlan, JPlan)
    plan = src_cls.from_assignment(assignment, (0, 2, 4, 8), (8,),
                                   meta=meta)
    plan.save(str(tmp_path / "plan"))
    loaded = dst_cls.load(str(tmp_path / "plan.json"))
    assert _plan_fields(loaded) == _plan_fields(plan)
    for g in plan.groups:
        assert loaded.channel_bits[g].dtype == np.int64
        assert loaded.permutations[g].dtype == np.int64


def test_export_plan_layers_byte_identical():
    """``export_plan_layers`` over LM plan groups packs exactly as the
    JAX package's, from the plan's stored permutations."""
    import jax
    from repro.configs import registry
    from repro.models import lm as jlm
    from repro.serve import engine as jeng
    from repro_torch.bridge import params_from_jax
    from repro_torch.models import lm as tlm
    from repro_torch.serve import engine as teng
    cfg = registry.get("llama3.2-1b-smoke")
    jp = jlm.init_params(cfg, jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    jplan = jeng.synthetic_plan(cfg, jp, bits=None, seed=0)
    tplan = teng.synthetic_plan(cfg, tp, bits=None, seed=0)
    groups = jplan.groups[::4]     # a few groups keep the JAX side quick
    jw = jlm.serve_weight_groups(cfg, jp)
    tw = tlm.serve_weight_groups(cfg, tp)
    ja = jeng.export_plan_layers(jplan, {g: jw[g] for g in groups})
    ta = teng.export_plan_layers(tplan, {g: tw[g] for g in groups})
    assert list(ja) == list(ta)
    for grp, (packed, perm, kept) in ja.items():
        tpacked, tperm, tkept = ta[grp]
        assert np.array_equal(perm, tperm) and kept == tkept
        assert [b for b, _, _ in packed] == [b for b, _, _ in tpacked]
        for (_, wa, sa), (_, wb, sb) in zip(packed, tpacked):
            assert np.asarray(wa).tobytes() == wb.numpy().tobytes()
            assert np.asarray(sa).tobytes() == sb.numpy().tobytes()
