"""``python -m repro_torch.launch.dryrun`` with no card and no JAX: smoke
cells (train with and without ``--search``, prefill, decode) on a (2, 2)
debug mesh over a fake group of four ranks, their records and tallies,
``--reanalyze`` recomputing the roofline from the tallies alone;
full-width llama3.2-1b ``decode_32k`` on the 16 x 16 and 2 x 16 x 16
production meshes over fake groups of 256 and 512 ranks, allocating
nothing (its process stays far below one rank's argument bytes); a
skipped cell, and a cell of the enc-dec family at published widths
(``seamless-m4t-medium`` ``decode_32k``: its ``cross_kv`` cache whole
on every rank but for its batch rows) traced."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

from torch_threads import _one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMOKE = [("train_4k", False), ("train_4k", True), ("prefill_32k", False),
         ("decode_32k", False)]
KEYS = {"arch", "shape", "mesh", "search", "ok", "memory_analysis",
        "collectives", "roofline"}
ROOF = {"flops_per_device", "bytes_per_device", "dot_bytes_per_device",
        "memory_s_lower", "collective_bytes_per_device", "compute_s",
        "memory_s", "collective_s", "dominant", "bound_step_s", "n_devices"}
_RUN = (
    "import runpy, sys\n"
    "sys.argv = ['dryrun'] + sys.argv[1:]\n"
    "rc = 0\n"
    "try:\n"
    "    runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    rc = e.code or 0\n"
    "hwm = [l for l in open('/proc/self/status') if l.startswith('VmHWM')]\n"
    "print('MAXRSS_KB', hwm[0].split()[1])\n"
    "sys.exit(rc)\n")


def _start(*args):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, "-c", _RUN, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _done(p):
    log, _ = p.communicate(timeout=600)
    return p.returncode, log


def _load(out, name):
    with open(os.path.join(out, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    smoke = ["--mesh", "2,2", "--batch", "8", "--seq", "64", "--out", out]
    procs = {(shape, search): _start(
        "--arch", "llama3.2-1b-smoke", "--shape", shape, *smoke,
        *(["--search"] if search else [])) for shape, search in SMOKE}
    procs["full"] = _start("--arch", "llama3.2-1b", "--shape", "decode_32k",
                           "--out", out)
    procs["full_mp"] = _start("--arch", "llama3.2-1b", "--shape",
                              "decode_32k", "--multi-pod", "--out", out)
    procs["skipped"] = _start("--arch", "llama3.2-1b", "--shape",
                              "long_500k", "--out", out)
    procs["refused"] = _start("--arch", "seamless-m4t-medium", "--shape",
                              "decode_32k", "--out", out)
    done = {k: _done(p) for k, p in procs.items()}
    return out, done


@pytest.mark.parametrize("shape,search", SMOKE)
def test_smoke_cell_record_and_tally(runs, shape, search):
    out, done = runs
    rc, log = done[(shape, search)]
    assert rc == 0, log[-3000:]
    name = f"llama3.2-1b-smoke__{shape}__2x2{'__search' if search else ''}"
    rec = _load(out, name + ".json")
    assert KEYS <= set(rec) and rec["ok"] is True, rec.get("error")
    assert ROOF <= set(rec["roofline"]) and rec["roofline"]["n_devices"] == 4
    r = rec["roofline"]
    assert r["flops_per_device"] > 0 and r["dot_bytes_per_device"] > 0
    assert r["bytes_per_device"] >= r["dot_bytes_per_device"]
    assert rec["collectives"]["count_by_kind"]["all-gather"] > 0
    mem = rec["memory_analysis"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    # decode updates its donated caches in place; prefill donates nothing
    if shape == "decode_32k":
        assert 0 < mem["alias_bytes"] <= mem["output_bytes"]
    else:
        assert mem["alias_bytes"] == 0
    tally = _load(out, name + ".tally.json")
    assert tally["n_devices"] == 4 and tally["ops"]["aten.mm"]["flops"] > 0
    assert "[dryrun] llama3.2-1b-smoke" in log and "-bound" in log


def test_search_cell_runs_the_quantizer_stack(runs):
    """The search step runs Eq. 5 on every projection (K4's plain
    version on meta): more bytes, the same products."""
    out, _ = runs
    plain = _load(out, "llama3.2-1b-smoke__train_4k__2x2.json")["roofline"]
    srch = _load(out, "llama3.2-1b-smoke__train_4k__2x2__search.json")
    assert srch["search"] is True
    assert srch["roofline"]["bytes_per_device"] > plain["bytes_per_device"]
    assert srch["roofline"]["flops_per_device"] == plain["flops_per_device"]


def test_reanalyze_recomputes_the_roofline_from_the_tallies(runs):
    out, _ = runs
    name = "llama3.2-1b-smoke__prefill_32k__2x2.json"
    before = _load(out, name)
    rec = dict(before, roofline={"dominant": "stale"}, collectives={})
    with open(os.path.join(out, name), "w") as f:
        json.dump(rec, f)
    rc, log = _done(_start("--reanalyze", "--out", out))
    assert rc == 0, log[-3000:]
    after = _load(out, name)
    assert after["roofline"] == before["roofline"]
    assert after["collectives"] == before["collectives"]
    assert f"[reanalyze] {name}: {before['roofline']['dominant']}" in log


@pytest.mark.parametrize("which,label,n", [("full", "16x16", 256),
                                           ("full_mp", "2x16x16", 512)])
def test_full_width_cell_allocates_nothing(runs, which, label, n):
    """llama3.2-1b decode_32k at published widths: rank 0's arguments
    (its parameter and cache shards) are 286 MiB (512 ranks) to 542 MiB
    (256 ranks), the global ones over 100 GiB; the process peaks under 1
    GiB (torch and the trace alone), and below rank 0's arguments on the
    16 x 16 mesh."""
    out, done = runs
    rc, log = done[which]
    assert rc == 0, log[-3000:]
    rec = _load(out, f"llama3.2-1b__decode_32k__{label}.json")
    assert rec["ok"] and rec["roofline"]["n_devices"] == n
    arg = rec["memory_analysis"]["argument_bytes"]
    assert arg * n > 100 * 2**30
    # the process's peak resident set since its exec (``VmHWM``;
    # ``ru_maxrss`` would count the forked pytest worker's pages)
    rss = int(log.split("MAXRSS_KB")[1].split()[0]) * 1024
    assert arg > 256 * 2**20 and rss < 2**30, (rss, arg)
    if n == 256:
        assert rss < arg, (rss, arg)
    assert rec["roofline"]["dominant"] in ("memory", "collective",
                                           "compute")


def test_skipped_and_refused_cells(runs):
    """A skipped cell is skipped; no cell is refused: the enc-dec
    ``decode_32k`` cell traces ``ok`` on 256 ranks, its arguments rank
    0's shards."""
    out, done = runs
    for which in ("skipped", "refused"):
        assert done[which][0] == 0, done[which][1][-3000:]
    skipped = _load(out, "llama3.2-1b__long_500k__16x16.json")
    assert "sub-quadratic" in skipped["skipped"] and "ok" not in skipped
    rec = _load(out, "seamless-m4t-medium__decode_32k__16x16.json")
    assert rec["ok"] is True and "refused" not in rec, rec.get("error")
    assert rec["roofline"]["n_devices"] == 256
    assert rec["roofline"]["flops_per_device"] > 0
    assert rec["memory_analysis"]["alias_bytes"] > 0
    assert "[dryrun] seamless-m4t-medium x decode_32k x 16x16" in \
        done["refused"][1]
