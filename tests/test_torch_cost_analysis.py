"""``repro_torch.distributed.cost_analysis`` on programs whose counts are
known: a product's 2 * M * N * K FLOPs and its operand and result bytes,
a T-step loop counted T times, the collectives of a fake process group
of four ranks by kind with the reference's ring traffic, the tally
round trip, and the ``Roofline`` terms and ``dominant`` against the
H100's datasheet peaks."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from repro_torch.distributed import cost_analysis as ca
from torch_threads import _one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("dev", ["cpu", "meta"])
@pytest.mark.parametrize("m,k,n", [(8, 16, 4), (128, 64, 256)])
def test_a_product_counts_2mnk(dev, m, k, n):
    a = torch.ones(m, k, device=dev)
    b = torch.ones(k, n, device=dev)
    out, tot, tally = ca.trace(torch.matmul, a, b)
    assert tuple(out.shape) == (m, n)
    assert tot.flops == 2 * m * n * k
    assert tot.dot_bytes == 4 * (m * k + k * n + m * n) == tot.bytes
    assert tally["ops"]["aten.mm"]["count"] == 1


def test_a_batched_float32_output_product_counts_its_operands():
    """``bmm``'s float32-output overload (the MoE banks' product on the
    card) counts 2 * B * M * N * K, not its dtype argument."""
    a = torch.ones(3, 4, 8, dtype=torch.bfloat16, device="meta")
    b = torch.ones(3, 8, 5, dtype=torch.bfloat16, device="meta")
    out, tot, _ = ca.trace(torch.bmm, a, b, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    assert tot.flops == 2 * 3 * 4 * 5 * 8
    assert tot.dot_bytes == 2 * (3 * 4 * 8 + 3 * 8 * 5) + 4 * 3 * 4 * 5


@pytest.mark.parametrize("steps", [1, 5, 12])
def test_a_t_step_loop_counts_t_times(steps):
    w = torch.ones(16, 16, device="meta")

    def loop(x):
        for _ in range(steps):
            x = torch.tanh(x @ w)
        return x

    _, tot, tally = ca.trace(loop, torch.ones(4, 16, device="meta"))
    assert tot.flops == steps * 2 * 4 * 16 * 16
    assert tally["ops"]["aten.mm"]["count"] == steps
    assert tally["ops"]["aten.tanh"]["count"] == steps
    # tanh: 4 x 16 float32 read and written
    assert tally["ops"]["aten.tanh"]["bytes"] == steps * 2 * 4 * 16 * 4


def test_views_and_allocations_move_no_bytes():
    x = torch.ones(8, 8, device="meta")
    _, tot, tally = ca.trace(lambda t: (t.view(64), t.T, t[2:4],
                                        torch.empty(1000, device="meta")), x)
    assert tot.bytes == 0 and tot.flops == 0
    assert not tally["ops"]


_COLLECTIVES = r"""
import json, sys
import torch
from repro_torch.distributed import cost_analysis as ca, sharding
from repro_torch.launch import dryrun, mesh as meshlib
dryrun.fake_group(4)
mesh = meshlib.make_debug_mesh(1, 4, device="meta")
g = mesh.group("model")
x = torch.empty(8, 16, dtype=torch.bfloat16, device="meta")

def prog():
    a = sharding.all_reduce_sum(x, g)            # bf16 summed in float32
    b = sharding.all_gather_cat(x, 0, g)
    c = sharding.reduce_scatter(x, 0, g)
    d = sharding.all_reduce_max(x, g)
    return a, b, c, d

out, tot, tally = ca.trace(prog)
print(json.dumps({"shapes": [list(t.shape) for t in out],
                  "counts": tot.coll_counts, "bytes": tot.coll_bytes,
                  "traffic": tot.collective_traffic_bytes,
                  "again": ca.Totals.from_tally(
                      tally["ops"], tally["coll_counts"],
                      tally["coll_bytes"]).collective_traffic_bytes}))
"""


def test_collectives_by_kind_on_a_fake_group_of_four():
    """Result bytes as the reference reads them off the HLO: an
    all-reduce's buffer (float32 for a bf16 sum, the element type of a
    MAX), an all-gather's gathered tensor, a reduce-scatter's block
    (float32); ring traffic 2x an all-reduce's, 1x the others'."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    done = subprocess.run([sys.executable, "-c", _COLLECTIVES], env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert got["shapes"] == [[8, 16], [32, 16], [2, 16], [8, 16]]
    assert got["counts"] == {"all-reduce": 2, "all-gather": 1,
                             "reduce-scatter": 1}
    ar = 8 * 16 * 4 + 8 * 16 * 2
    assert got["bytes"] == {"all-reduce": ar, "all-gather": 32 * 16 * 2,
                            "reduce-scatter": 2 * 16 * 4}
    want = 2 * ar + 32 * 16 * 2 + 2 * 16 * 4
    assert got["traffic"] == want == got["again"]


def test_roofline_terms_and_dominant():
    r = ca.Roofline(flops_per_device=989e12, bytes_per_device=6.7e12,
                    collective_bytes=450e9, n_devices=256,
                    dot_bytes_per_device=3.35e12)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.memory_s_lower == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(1.0)
    assert r.dominant == "memory" and r.step_s == pytest.approx(2.0)
    d = r.as_dict()
    assert set(d) >= {"flops_per_device", "bytes_per_device",
                      "dot_bytes_per_device", "memory_s_lower",
                      "collective_bytes_per_device", "compute_s",
                      "memory_s", "collective_s", "dominant",
                      "bound_step_s", "n_devices"}
    assert "H100" in d["card"]
    assert ca.Roofline(1e15, 1, 1, 1).dominant == "compute"
    assert ca.Roofline(1, 1, 1e12, 1).dominant == "collective"
