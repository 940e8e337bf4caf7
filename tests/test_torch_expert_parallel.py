"""The expert-parallel MoE layer (``nn/blocks.moe_layer`` under a mesh,
``distributed/sharding.py``) on spawned gloo ranks on the CPU, against
the port's single-device layer and the JAX package's ``shard_map``.

The ranks install the rule overrides that unmap every axis but
``batch`` and ``experts`` (``torch_ep_cases.EP_RULES``): the
expert-parallel layout alone.  For each registry MoE arch's smoke layer
(``torch_ep_cases``: arctic
top-2 with the shared FFN, scout top-1 with it, jamba's MoE slot top-2
without it), weights in float32 and bf16, on meshes ``(1, 2)``, ``(1,
4)`` and ``(2, 2)`` (one spawn of gloo ranks a mesh, every case in it):

* the layer's output equals the port's single-device layer on the same
  data shard bit for bit, float and under the search context: the
  shard's capacity is its own ``t_loc``, each rank routes every token
  over all E experts and runs its own, and the float32 partial sums add
  only exact zeros (a token reaches at most ``top_k`` <= 2 experts);
  every model rank holds the same output;
* under the search context each bank's absmax on every rank is the
  whole bank's per-channel maximum, bit for bit; the gradients of the
  input, the router, the banks (this rank's experts), the bank gammas
  and the shared FFN against the single-device layer's on that shard:
  the banks' bit for bit (each expert's products are the same), the
  rest within ``EP_GRAD`` relative L2: a rank's partial gradients of
  the input and the router are rounded to bf16 where autograd sums them
  inside the rank, then summed over the ranks, where the single layer
  rounds its one sum;
* against ``repro.nn.blocks.moe_layer`` on a four-device JAX CPU mesh
  (``torch_ep_jax.py``, one subprocess for the module, started beside
  the ranks): the output and every gradient, the data shards joined,
  within ``PORT_SINGLE`` (the port's single-device layer against the
  JAX package's, held here too) plus ``EP_GRAD`` (the port's own mesh
  against its single layer, above) plus the JAX package's own spread
  between its mesh and its single-device layer run shard by shard
  (``single`` with ``dp`` data shards, read in the same subprocess).
  The JAX mesh keeps the input's and the router's gradients bitwise to
  its single layer (spread 0), so their gap is the port's ``EP_GRAD``
  term.
"""
import contextlib
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_ep_cases as ec
from torch_threads import _one_torch_thread  # noqa: F401

HERE = pathlib.Path(__file__).resolve().parent
CASES = [(a, d) for a in ec.SLOT for d in ec.DTYPES]
# the EP layer's non-bank gradients against the single-device layer's on
# the same shard: 1.5x the largest reading (4.62e-3, jamba's bf16 router
# at (1, 4))
EP_GRAD = 7e-3
# the port's single-device layer against the JAX package's under the
# search: output bitwise; gradients within 1.5x the largest reading
# (1.67e-5, jamba's float32 input gradient)
PORT_SINGLE = 2.5e-5


def _worker(rank, world, shape, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        torch.save(_rank_cases(shape), os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _rank_cases(shape):
    """Every case on this rank: the EP layer and the single-device layer
    on this rank's data shard, float and searched."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import registry as treg
    from repro_torch.core import mps
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.nn import blocks

    mesh = meshlib.make_debug_mesh(*shape, device="cpu")
    out = {}
    for arch, dtype in CASES:
        cfg = treg.get(arch)
        ffn, x, ct = ec.case(arch, dtype)
        whole = params_from_jax(ffn)
        xb = torch.tensor(x).to(torch.bfloat16)
        ctt = torch.tensor(ct)
        res = {}
        with sharding.use_mesh(mesh, ec.EP_RULES):
            d, dp = sharding.axis_index("batch"), sharding.extent("batch")
            rows = slice(d * ec.B // dp, (d + 1) * ec.B // dp)
            shard = steps.shard_tree(whole, ec.logical(arch))
        for label, ctx in (("float", None), ("search", mps.SearchCtx())):
            for where, p in (("ep", shard), ("single", whole)):
                seen = []
                inner = sharding.all_reduce_max

                def rec(v, group):
                    got = inner(v, group)
                    seen.append(got.clone())
                    return got

                sharding.all_reduce_max = rec
                p = {k: _leaf_grad(v) for k, v in p.items()}
                xi = xb[rows].clone().requires_grad_()
                try:
                    with sharding.use_mesh(mesh, ec.EP_RULES) if where == "ep" else \
                            contextlib.nullcontext():
                        y = blocks.moe_layer(p, xi, cfg, effective_w=(
                            lm._make_getw(cfg, ctx)))
                        if ctx is not None:
                            (y.float() * ctt[rows]).sum().backward()
                finally:
                    sharding.all_reduce_max = inner
                r = {"y": y.detach().float().numpy()}
                if ctx is not None:
                    r["x"] = xi.grad.float().numpy()
                    r.update({f"p/{k}": v for k, v in ec.flat(
                        _grads(p)).items()})
                    r["absmax"] = [v.numpy() for v in seen]
                res[f"{label}/{where}"] = r
        res["rows"] = rows
        out[(arch, dtype)] = res
    return {"coords": mesh.coords, "cases": out}


def _leaf_grad(tree):
    if isinstance(tree, dict):
        return {k: _leaf_grad(v) for k, v in tree.items()}
    return tree.clone().requires_grad_()


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return torch.zeros_like(tree) if tree.grad is None else tree.grad


@pytest.fixture(scope="module")
def world():
    """Every mesh's ranks (one spawn each) and the JAX subprocess."""
    tmp = tempfile.mkdtemp()
    jax_out = os.path.join(tmp, "jax.npz")
    env = {**os.environ, "XLA_FLAGS":
           "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join(
               [str(HERE), str(HERE.parent / "src"),
                os.environ.get("PYTHONPATH", "")])}
    jax_proc = subprocess.Popen([sys.executable, str(HERE / "torch_ep_jax.py"),
                                 jax_out], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    ranks = {}
    for shape in ec.MESHES:
        n = shape[0] * shape[1]
        out_dir = os.path.join(tmp, f"{shape[0]}x{shape[1]}")
        os.makedirs(out_dir)
        mp.spawn(_worker, args=(n, shape, f"file://{out_dir}/rdv", out_dir),
                 nprocs=n)
        ranks[shape] = [torch.load(os.path.join(out_dir, f"{r}.pt"),
                                   weights_only=False) for r in range(n)]
    log, _ = jax_proc.communicate()
    assert jax_proc.returncode == 0, log[-3000:]
    with np.load(jax_out) as z:
        jax_res = {k: z[k] for k in z.files}
    return {"ranks": ranks, "jax": jax_res}


PARAMS = [(s, a, d) for s in ec.MESHES for a, d in CASES]
IDS = [f"{s[0]}x{s[1]}-{a.split('-')[0]}-{d}" for s, a, d in PARAMS]


@pytest.mark.parametrize("shape,arch,dtype", PARAMS, ids=IDS)
def test_output_bitwise_against_single_device(world, shape, arch, dtype):
    for r in world["ranks"][shape]:
        res = r["cases"][(arch, dtype)]
        for label in ("float", "search"):
            np.testing.assert_array_equal(
                res[f"{label}/ep"]["y"], res[f"{label}/single"]["y"],
                err_msg=f"{label} {r['coords']}")


@pytest.mark.parametrize("shape,arch,dtype", PARAMS, ids=IDS)
def test_bank_absmax_is_global_and_gradients_match(world, shape, arch,
                                                   dtype):
    """Each of the 3 banks' all-reduced absmax is the whole bank's
    per-channel max (bitwise); the bank gradients equal the
    single-device layer's rows of this rank's experts; the rest within
    ``EP_GRAD``; the bank gammas' gradients are nonzero."""
    ffn, _, _ = ec.case(arch, dtype)
    want = [np.abs(np.asarray(ffn[n]["w"], np.float32)).max(axis=(0, 1))
            for n in ("w_gate", "w_up", "w_down")]
    e = want and np.asarray(ffn["w_gate"]["w"]).shape[0]
    for r in world["ranks"][shape]:
        res = r["cases"][(arch, dtype)]
        ep, single = res["search/ep"], res["search/single"]
        assert len(ep["absmax"]) == 3 and not single["absmax"]
        for got, w in zip(ep["absmax"], want):
            np.testing.assert_array_equal(got, w)
        e_loc = e // shape[1]
        rows = slice(r["coords"]["model"] * e_loc,
                     (r["coords"]["model"] + 1) * e_loc)
        for k, v in single.items():
            if k in ("absmax", "y"):
                continue
            if k.endswith(("w_gate/w", "w_up/w", "w_down/w")) and \
                    "shared" not in k:
                np.testing.assert_array_equal(ep[k], v[rows], err_msg=k)
            else:
                assert ec.rel(ep[k], v) <= EP_GRAD, (k, ec.rel(ep[k], v))
        for n in ("w_gate", "w_up", "w_down"):
            assert np.abs(ep[f"p/{n}/gamma"]).sum() > 0


def _joined(ranks, arch, dtype, where):
    """The whole batch's output and gradients from the ranks: the data
    shards' rows joined, each bank's experts joined over ``model``, and
    the parameter gradients summed over the data shards (float64)."""
    by = {(r["coords"]["data"], r["coords"]["model"]):
          r["cases"][(arch, dtype)][f"search/{where}"] for r in ranks}
    dp = 1 + max(d for d, _ in by)
    tp = 1 + max(m for _, m in by)
    out = {"y": np.concatenate([by[d, 0]["y"] for d in range(dp)]),
           "x": np.concatenate([by[d, 0]["x"] for d in range(dp)])}
    for k in by[0, 0]:
        if not k.startswith("p/"):
            continue
        bank = where == "ep" and k.endswith(
            ("w_gate/w", "w_up/w", "w_down/w")) and "shared" not in k
        out[k] = sum(np.concatenate([by[d, m][k] for m in range(tp)])
                     if bank else by[d, 0][k].astype(np.float64)
                     for d in range(dp))
    return out


@pytest.mark.parametrize("shape,arch,dtype", PARAMS, ids=IDS)
def test_matches_the_jax_shard_map(world, shape, arch, dtype):
    """The joined output and gradients against the JAX package's mesh
    layer, within ``PORT_SINGLE + EP_GRAD`` plus the JAX package's own
    spread between its mesh layer and its single-device layer on the
    same data shards; the port's single-device layer against the JAX
    package's within ``PORT_SINGLE`` (its output bitwise)."""
    jx = world["jax"]
    dp = shape[0]
    key = f"{arch}|{dtype}"
    port = _joined(world["ranks"][shape], arch, dtype, "ep")
    single = _joined(world["ranks"][shape], arch, dtype, "single")
    assert sorted(port) == sorted(
        k.split("|")[-1] for k in jx if k.startswith(f"{key}|single{dp}|"))
    np.testing.assert_array_equal(single["y"], jx[f"{key}|single{dp}|y"])
    for k, v in port.items():
        jm = jx[f"{key}|{shape[0]},{shape[1]}|{k}"]
        js = jx[f"{key}|single{dp}|{k}"]
        assert ec.rel(single[k], js) <= PORT_SINGLE, (k, ec.rel(single[k],
                                                                js))
        spread = ec.rel(jm, js)
        assert ec.rel(v, jm) <= PORT_SINGLE + EP_GRAD + spread, (
            k, ec.rel(v, jm), spread)


# ---------------------------------------------------------------------------
# the pieces a bank shard's Eq. 5 weight rests on (no ranks)
# ---------------------------------------------------------------------------

def test_size_cost_counts_every_expert_of_a_shard():
    """``mps_size_cost`` of a tree holding a rank's half of each bank is
    the whole tree's: a bank's C_in counts all ``cfg.n_experts`` (not
    the shard's), and the cost is whole on every rank."""
    from repro_torch.configs import registry as treg
    from repro_torch.core import mps
    from repro_torch.models import lm

    cfg = treg.get("arctic-480b-smoke")
    whole = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", mps_on=True)
    half = {**whole, "blocks": {"l0": {**whole["blocks"]["l0"], "ffn": {
        k: ({**v, "w": v["w"][:, :cfg.n_experts // 2]}
            if k in ("w_gate", "w_up", "w_down") else v)
        for k, v in whole["blocks"]["l0"]["ffn"].items()}}}}
    ctx = mps.SearchCtx()
    assert torch.equal(lm.mps_size_cost(cfg, half, ctx),
                       lm.mps_size_cost(cfg, whole, ctx))


def test_k4_plain_version_takes_a_given_absmax():
    """K4's wrapper on CPU tensors (its plain version) with ``absmax_in``
    equals the quantizer stack given the same per-channel absmax (one
    row's raised, as another rank's rows would); the autograd function's
    gradient reads the given absmax; a CUDA / CPU mix, a wrong shape and
    ``absmax`` with ``absmax_in`` raise."""
    from repro_torch.core import quantizers
    from repro_torch.kernels.mps_combine import ops as mops

    pw = (0, 2, 4, 8)
    g = torch.Generator().manual_seed(2)
    w = torch.randn(6, 40, generator=g)
    probs = torch.softmax(torch.randn(6, 4, generator=g), -1)
    absmax = torch.amax(w.abs(), 1)
    absmax[2] *= 1.5
    got = mops.mps_combine_fwd(w, probs, pw, absmax_in=absmax)
    qs = quantizers.quantize_weights_multi(w, pw, 0, absmax[:, None])
    want = sum(probs[:, i:i + 1] * qs[i] for i in range(len(pw)) if pw[i])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert torch.equal(got[[0, 1, 3, 4, 5]],
                       mops.mps_combine_ref(w, probs, pw)[[0, 1, 3, 4, 5]])
    assert not torch.equal(got[2], mops.mps_combine_ref(w, probs, pw)[2])
    wk = w.clone().requires_grad_()
    up = torch.randn(6, 40, generator=g)
    (mops.mps_combine(wk, probs, pw, absmax) * up).sum().backward()
    want_dw, _ = mops._vjp_bwd(w, probs, pw, up, absmax)
    assert torch.equal(wk.grad, want_dw)
    with pytest.raises(ValueError):
        mops.mps_combine_fwd(w, probs, pw, absmax_in=absmax[:5])
    with pytest.raises(ValueError, match="not both"):
        mops.mps_combine_fwd(w, probs, pw, torch.empty(6), absmax_in=absmax)
    with pytest.raises(ValueError, match="cpu tensor"):
        mops.mps_combine_fwd(w, probs, pw, absmax_in=absmax.double())
