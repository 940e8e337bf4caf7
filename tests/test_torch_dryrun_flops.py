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
the projection on both data ranks (ROADMAP section 3)."""
import json
import os
import subprocess
import sys
import tempfile

import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from torch_threads import _one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
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
_PORT = (
    "import json, sys\n"
    "from repro_torch.launch import dryrun\n"
    "out = {}\n"
    "for a, s, b, n, srch in json.loads(sys.argv[1]):\n"
    "    rec, _ = dryrun.run_cell(a, s, search=srch, verbose=False,\n"
    "                             mesh=(2, 2), batch=b, seq=n)\n"
    "    assert rec.get('ok'), rec\n"
    "    out['|'.join(map(str, (a, s, b, n, srch)))] = rec\n"
    "print(json.dumps(out))\n")


@pytest.fixture(scope="module")
def both():
    tmp = tempfile.mkdtemp()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [HERE, os.path.join(HERE, "..", "src"),
         os.environ.get("PYTHONPATH", "")])}
    jax = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dryrun_jax.py"),
         os.path.join(tmp, "jax.json"), json.dumps(CELLS)],
        env={**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=4"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = subprocess.run([sys.executable, "-c", _PORT, json.dumps(CELLS)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    log, _ = jax.communicate(timeout=600)
    assert jax.returncode == 0, log[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]
    with open(os.path.join(tmp, "jax.json")) as f:
        return json.loads(port.stdout.strip().splitlines()[-1]), json.load(f)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}"
                         f"{'-search' if c[4] else ''}")
def test_dot_flops_match_jax_hlo_analysis(both, cell):
    port, jax = both
    key = "|".join(map(str, cell))
    got = port[key]["roofline"]["flops_per_device"]
    want = jax[key]["flops"]
    assert want > 0 and abs(got / want - 1) <= TOL, (got, want)
