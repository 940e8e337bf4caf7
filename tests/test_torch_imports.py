"""The port stands alone: importing it loads neither JAX nor ``repro``,
no file of it (or ``chip_smoke.py``) imports them, and its entry points
refuse to fall back to the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency
from torch_threads import _one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def test_import_loads_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch\n"
        "import repro_torch.serve.engine, repro_torch.launch.serve\n"
        "import repro_torch.bridge, repro_torch.api.plan\n"
        "import repro_torch.core.rng, repro_torch.core.quantizers\n"
        "import repro_torch.core.sampling, repro_torch.core.mps\n"
        "import repro_torch.core.costs, repro_torch.core.discretize\n"
        "import repro_torch.nn.layers, repro_torch.models.cnn\n"
        "import repro_torch.data.synthetic, repro_torch.optim.optimizers\n"
        "import repro_torch.optim.schedules, repro_torch.api.cost_models\n"
        "import repro_torch.api.phases, repro_torch.api.compressor\n"
        "import repro_torch.kernels.mps_combine.ops\n"
        "import repro_torch.kernels.mps_combine.ref\n"
        "import repro_torch.kernels.ssd_scan.ops\n"
        "import repro_torch.launch.search\n"
        "import repro_torch.launch.train, repro_torch.launch.steps\n"
        "import repro_torch.optim.grad, repro_torch.checkpoint.checkpoint\n"
        "import repro_torch.models.lm\n"
        "import repro_torch.sweep, repro_torch.sweep.front\n"
        "import repro_torch.sweep.store, repro_torch.sweep.runner\n"
        "import repro_torch.launch.sweep, repro_torch.core.pipeline\n"
        "import repro_torch.obs, repro_torch.obs.validate\n"
        "import repro_torch.chaos, repro_torch.fleet\n"
        "import repro_torch.launch.fleet\n"
        "import repro_torch.distributed.sharding, repro_torch.launch.mesh\n"
        "import repro_torch.distributed.cost_analysis\n"
        "import repro_torch.launch.dryrun\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.') or m == 'triton']\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_entry_points_refuse_cpu_fallback():
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.serve import engine
    cfg = registry.get("llama3.2-1b-smoke")
    params = lm.init_params(cfg, device="cpu")
    if torch.cuda.is_available():
        assert engine.InferenceServer(cfg, params, max_len=16,
                                      max_batch=1).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.InferenceServer(cfg, params, max_len=16, max_batch=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg)
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "llama3.2-1b-smoke", "--steps", "1"])
    from repro_torch.launch import sweep
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.main(["--track", "cnn", "--bench", "gsc", "--width", "4",
                    "--store", "unused", "--workdir", "unused"])
    from repro_torch.launch import fleet
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.main(["--arch", "llama3.2-1b-smoke", "--tiers", "float"])


def test_jamba_builds_standalone():
    """The hybrid (jamba) smoke arch builds and runs a prefill on the CPU
    in a fresh interpreter that has loaded no JAX, no ``repro`` and no
    CUDA library of the port's kernels, and no family of the port's
    registry is refused any more (every arch's tree builds on the meta
    device); the MoE-bearing stack takes a search train step."""
    code = (
        "import sys, torch\n"
        "import repro_torch\n"
        "from repro_torch.configs import registry\n"
        "from repro_torch.kernels import build\n"
        "from repro_torch.models import lm\n"
        "cfg = registry.get('jamba-1.5-large-398b-smoke')\n"
        "p = lm.init_params(cfg, device='cpu')\n"
        "tok = torch.zeros((1, 8), dtype=torch.int32)\n"
        "logits, caches = lm.forward(cfg, p, {'tokens': tok})\n"
        "assert logits.shape == (1, 8, lm.padded_vocab(cfg))\n"
        "assert sorted(caches['l4']) == ['kv'] and "
        "sorted(caches['l3']) == ['mamba']\n"
        "assert len(lm._plan_weights(cfg)) == 58\n"
        "for name in registry.ARCHS:\n"
        "    lm.init_params(registry.get(name), device='meta')\n"
        "from repro_torch.data import synthetic\n"
        "from repro_torch.launch import steps\n"
        "from repro_torch.optim import optimizers\n"
        "p = lm.init_params(cfg, device='cpu', mps_on=True)\n"
        "opt = optimizers.make_optimizer(cfg.optimizer, 3e-4)\n"
        "step = steps.make_train_step(cfg, opt, search=True)\n"
        "batch = synthetic.lm_batch(cfg.vocab, 33, 2, 0, device='cpu')\n"
        "p2, _, loss = step(p, opt.init(p), batch, 0)\n"
        "assert torch.isfinite(loss), loss\n"
        "g = p['blocks']['l1']['ffn']['w_up']['gamma']\n"
        "assert not torch.equal(p2['blocks']['l1']['ffn']['w_up']['gamma'],"
        " g)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.') or m == 'triton']\n"
        "assert not bad, bad\n"
        "assert not build._LOADED, build._LOADED\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_c3_families_build_standalone():
    """Both C3 smoke arches build and run a prefill on the CPU in a fresh
    interpreter that has loaded no JAX, no ``repro`` and no CUDA
    library of the port's kernels."""
    code = (
        "import sys, torch\n"
        "import repro_torch\n"
        "from repro_torch.configs import registry\n"
        "from repro_torch.kernels import build\n"
        "from repro_torch.models import lm\n"
        "for arch in ('seamless-m4t-medium-smoke', 'qwen2-vl-72b-smoke'):\n"
        "    cfg = registry.get(arch)\n"
        "    p = lm.init_params(cfg, device='cpu', mps_on=True)\n"
        "    tok = torch.zeros((1, 8), dtype=torch.int32)\n"
        "    logits, _ = lm.forward(cfg, p, {'tokens': tok})\n"
        "    assert logits.shape == (1, 8, lm.padded_vocab(cfg))\n"
        "    assert lm.mps_param_count(cfg) == (18 if cfg.is_encdec else 7)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.') or m == 'triton']\n"
        "assert not bad, bad\n"
        "assert not build._LOADED, build._LOADED\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def _obs_server(reg):
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.obs import Observability
    from repro_torch.serve import engine
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.scheduler import Request
    cfg = registry.get("llama3.2-1b-smoke")
    srv = engine.InferenceServer(
        cfg, lm.init_params(cfg, device="cpu"), max_len=16, max_batch=1,
        cache="paged", page_size=8, obs=Observability(registry=reg),
        device="cpu")
    srv.serve([Request(uid=0, prompt=[1, 2, 3],
                       sampling=SamplingParams(max_tokens=2))])
    return {"serve_requests_total", "serve_admissions_total",
            "serve_prefill_tokens_total", "serve_decode_steps_total",
            "serve_tokens_total", "serve_trace_events_total",
            "serve_ttft_seconds", "serve_queue_depth"}


def _obs_cache(reg):
    from repro_torch.configs import registry
    from repro_torch.serve import cache
    backend = cache.make_backend("paged", registry.get("llama3.2-1b-smoke"),
                                 1, 16, "cpu", page_size=8)
    backend.bind_metrics(reg)
    backend.alloc(0, 0, 3)
    backend.publish_metrics()
    return {"serve_pool_exhausted_total", "serve_pages_in_use",
            "serve_cache_pages_in_use", "serve_cache_pool_bytes"}


def _obs_compressor(reg):
    from repro_torch.api import compressor, phases
    from repro_torch.data import synthetic
    from repro_torch.models import cnn
    comp = compressor.Compressor(cnn.dscnn(width=4), synthetic.GSC_LIKE,
                                 batch=4, device="cpu")
    comp.run([phases.Warmup(steps=2)], registry=reg,
             hooks=[phases.MetricsLog(every=1, printer=lambda line: None)])
    return {"compress_step_value", "compress_step_points_total",
            "compress_phase_seconds"}


def _sweep_spec():
    from repro_torch import sweep
    return sweep.SweepSpec(name="o", track="cnn", bench="gsc",
                           lams=(2.0,), warmup_steps=1, search_steps=1,
                           finetune_steps=1, batch=4, width=4,
                           eval_batches=1, checkpoint_every=1)


def _obs_sweep_runner(reg, tmp_path):
    from repro_torch import sweep
    from repro_torch.obs import RequestTracer
    tracer = RequestTracer(reg)
    sweep.SweepRunner(_sweep_spec(), sweep.PlanStore(str(tmp_path / "s")),
                      str(tmp_path / "w"), registry=reg, tracer=tracer,
                      verbose=False, device="cpu").run()
    assert [e.kind for e in tracer.events] == [
        "point_enqueued", "point_started", "point_finished"]
    return {"sweep_points_completed_total", "sweep_search_steps_total",
            "sweep_steps_saved_total", "sweep_front_size",
            "sweep_trace_events_total", "compress_phase_seconds"}


def _obs_launch_sweep(tmp_path):
    from repro_torch.launch import sweep
    from repro_torch.obs import validate
    m, t = str(tmp_path / "m.prom"), str(tmp_path / "t.jsonl")
    sweep.main(["--device", "cpu", "--track", "cnn", "--bench", "gsc",
                "--width", "4", "--lams", "2", "--warmup-steps", "1",
                "--search-steps", "1", "--finetune-steps", "1",
                "--eval-batches", "1", "--batch", "4",
                "--store", str(tmp_path / "s"),
                "--workdir", str(tmp_path / "w"),
                "--metrics", m, "--trace", t])
    assert validate.validate_files(m, t, validate.SCHEMA_PATH) == []
    with open(m) as f:
        return {ln.split()[2] for ln in f if ln.startswith("# TYPE")}


@pytest.mark.parametrize("refuser", ["server", "cache", "compressor",
                                     "sweep_runner", "launch_sweep"])
def test_former_obs_refusers_write_reference_metrics(refuser, tmp_path):
    """The five places that refused the observability layer until it was
    ported (the server's ``obs=``, the cache backends' metric hooks,
    ``Compressor.run(registry=)``, ``SweepRunner(registry=, tracer=)``
    and ``launch/sweep.py --metrics/--trace``) now take a registry and
    write the JAX package's metric names."""
    from repro_torch.obs import MetricsRegistry
    reg = MetricsRegistry()
    if refuser == "launch_sweep":
        names = _obs_launch_sweep(tmp_path)
        want = {"sweep_points_completed_total", "sweep_front_size",
                "compress_phase_seconds", "sweep_trace_events_total"}
        assert want <= names, want - names
        return
    call = {"server": _obs_server, "cache": _obs_cache,
            "compressor": _obs_compressor}.get(refuser)
    want = call(reg) if call else _obs_sweep_runner(reg, tmp_path)
    have = set(reg.snapshot())
    assert want <= have, want - have


def test_device_sampling_draws_deterministically():
    """Device sampling used to raise for temperature > 0 (ROADMAP A6);
    with the threefry2x32 generator ported it draws, and the draw is a
    function of the request alone (the same request twice gives the
    same tokens; ``test_torch_rng`` holds them against the JAX
    package's)."""
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.serve import engine
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.scheduler import Request
    cfg = registry.get("llama3.2-1b-smoke")
    srv = engine.InferenceServer(cfg, lm.init_params(cfg, device="cpu"),
                                 max_len=16, max_batch=1, device="cpu")
    req = Request(uid=0, prompt=[1, 2, 3],
                  sampling=SamplingParams(temperature=0.7, max_tokens=2))
    first = srv.serve([req])[0]
    assert len(first) == 2
    np.testing.assert_array_equal(srv.serve([req])[0], first)


def test_mesh_layer_stands_alone():
    """The mesh layer imports neither JAX nor ``repro``; the production
    mesh raises, naming the ranks it needs (256, or 512 with pods)."""
    code = (
        "import sys\n"
        "from repro_torch.distributed import sharding\n"
        "from repro_torch.launch import mesh\n"
        "for kw, n in (({}, 256), ({'multi_pod': True}, 512)):\n"
        "    try:\n"
        "        mesh.make_production_mesh(device='cpu', **kw)\n"
        "    except RuntimeError as e:\n"
        "        assert f'need {n} ranks' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('no error')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_dryrun_stands_alone():
    """A dry-run cell traced on a fake group of four ranks (prefill of a
    smoke arch on a (2, 2) mesh) loads neither JAX nor ``repro``."""
    code = (
        "import sys\n"
        "from repro_torch.launch import dryrun\n"
        "rec, tally = dryrun.run_cell('llama3.2-1b-smoke', 'prefill_32k',\n"
        "                             verbose=False, mesh=(2, 2), batch=4,\n"
        "                             seq=32)\n"
        "assert rec['ok'] and tally['ops'], rec\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
