"""The port's ``CheckpointManager`` (``repro_torch.checkpoint``): the
reference's own cases (``tests/test_optim_checkpoint.py``'s
``TestCheckpoint``) against the port's manager, a bf16 leaf restored bit
for bit, and float32 files written by either package restored by the
other."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro.checkpoint.checkpoint import CheckpointManager as JaxManager
from repro_torch.checkpoint.checkpoint import CheckpointManager
from torch_threads import _one_torch_thread  # noqa: F401


def _tree(v=0.0):
    return {"layer": {"w": torch.full((4, 3), v), "b": torch.zeros(3)},
            "step_arrays": [torch.ones(2), torch.zeros(())]}


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _tree(7.0))
    out, meta = mgr.restore(3, _tree())
    assert meta["step"] == 3
    assert torch.equal(out["layer"]["w"], torch.full((4, 3), 7.0))
    assert isinstance(out["step_arrays"], list) and \
        out["step_arrays"][1].shape == ()


def test_restore_latest_skips_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1.0))
    mgr.save(2, _tree(2.0))
    with open(mgr._fname(mgr.all_steps()[-1]), "wb") as f:
        f.write(b"garbage")
    out, meta = mgr.restore_latest(_tree())
    assert meta["step"] == 1
    assert torch.equal(out["layer"]["w"], torch.full((4, 3), 1.0))
    assert mgr.latest_step_and_meta() == (1, {"step": 1})


def test_retention_gc_and_pins(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, _tree(float(s)), pin=s == 1)
    assert mgr.all_steps() == [1, 3, 4]
    mgr.unpin(1)
    mgr.save(5, _tree(5.0))
    assert mgr.all_steps() == [4, 5]


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(10, _tree(5.0), blocking=False, metadata={"phase": "search"})
    mgr.wait()
    out, meta = mgr.restore_latest(_tree())
    assert meta == {"step": 10, "phase": "search"}
    assert mgr.peek_meta(10) == meta
    assert torch.equal(out["layer"]["w"], torch.full((4, 3), 5.0))


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    bad = {"layer": {"w": torch.zeros(5, 5), "b": torch.zeros(3)},
           "step_arrays": [torch.ones(2), torch.zeros(())]}
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(1, bad)
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore(1, {"other": torch.zeros(3)})


def test_restore_takes_the_templates_dtype(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(3.0))
    tmpl = _tree()
    tmpl["layer"]["w"] = tmpl["layer"]["w"].double()
    out, _ = mgr.restore_latest(tmpl)
    assert out["layer"]["w"].dtype == torch.float64
    assert torch.equal(out["layer"]["w"], torch.full((4, 3), 3.0,
                                                     dtype=torch.float64))


def test_bf16_leaf_round_trip_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.normal(size=(5, 7)), dtype=torch.bfloat16)
    w[0, 0] = float("nan")
    w[0, 1] = float("-inf")
    tree = {"w": w, "n": torch.arange(4, dtype=torch.int8),
            "s": torch.tensor(1.5)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, tree)
    tmpl = {"w": torch.zeros(5, 7, dtype=torch.bfloat16),
            "n": torch.zeros(4, dtype=torch.int8), "s": torch.zeros(())}
    out, meta = mgr.restore(2, tmpl)
    assert meta == {"step": 2}
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(out["n"], tree["n"]) and float(out["s"]) == 1.5


def test_float32_files_cross_load_both_ways(tmp_path):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    jtree = {"layer": {"w": jnp.asarray(w), "b": jnp.asarray(b)},
             "step_arrays": [jnp.ones(2), jnp.zeros(())]}
    JaxManager(str(tmp_path / "jax")).save(4, jtree, metadata={"k": 1})
    out, meta = CheckpointManager(str(tmp_path / "jax")).restore_latest(
        _tree())
    assert meta == {"step": 4, "k": 1}
    np.testing.assert_array_equal(out["layer"]["w"].numpy(), w)
    np.testing.assert_array_equal(out["layer"]["b"].numpy(), b)

    ttree = {"layer": {"w": torch.tensor(w), "b": torch.tensor(b)},
             "step_arrays": [torch.ones(2), torch.zeros(())]}
    CheckpointManager(str(tmp_path / "torch")).save(6, ttree)
    jout, jmeta = JaxManager(str(tmp_path / "torch")).restore_latest(jtree)
    assert jmeta == {"step": 6}
    np.testing.assert_array_equal(np.asarray(jout["layer"]["w"]), w)
    np.testing.assert_array_equal(np.asarray(jout["step_arrays"][0]),
                                  np.ones(2, np.float32))
