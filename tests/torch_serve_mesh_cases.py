"""What the serving mesh suites (``tests/test_torch_serve_mesh_*.py``)
share: the prefill and decode steps of a smoke arch on a mesh of four
spawned gloo ranks under the reference's rules (the arch's
``RULE_OVERRIDES`` and ``steps.shape_rules`` of a prefill or decode
shape), beside the JAX package's same steps jitted on a four-device CPU
mesh (``torch_serve_mesh_jax.py``, a subprocess started beside the
ranks) and beside the port's own (1, 1) steps.

Two runs:

* ``serve`` -- prefill ``B`` prompts of ``S`` tokens under the prefill
  rules (the sequence and the cache split over ``model``, FSDP over
  ``data``); the caches gathered and copied into a dense cache of
  ``S_MAX`` positions; ``T`` decode steps at positions ``S .. S + T - 1``
  under the ``decode_32k`` rules, teacher-forced with tokens drawn from
  the seed (a Mamba-2 stack keeps its state: no positions);
* ``long`` -- batch 1 under the ``long_500k`` rules (``batch``
  unmapped, the cache's sequence over every mesh axis): a cache of
  ``S_MAX`` positions filled from the seed, then ``T`` decode steps at
  the last ``T`` positions, so only the last rank writes.

Every input is drawn with numpy from the case's seed; the parameters
are the port's seed-0 ``init_params`` as numpy.  A stub frontend's arch
(VLM, enc-dec) is fed ``embeddings`` in place of tokens, prompt and
decode steps alike, and an enc-dec's prefill also ``enc_embeddings`` of
``S`` positions (``steps.batch_struct``'s keys): its decode cache holds
the ``cross_kv`` of those positions beside the self attention's.  This
module imports no JAX: the ranks import it.
"""
import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_mesh_train_cases as mc
from repro_torch.bridge import (lm_params_from_jax, lm_shard_from_jax,
                                tree_to_numpy)
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import lm as tlm

HERE = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    mesh: tuple
    run: str            # serve | long
    b: int = 4          # batch (1 under ``long``)
    s: int = 32         # prompt length (``serve``)
    s_max: int = 64     # the decode cache's positions
    t: int = 4          # decode steps
    seed: int = 0

    @property
    def label(self):
        return f"{self.arch}|{self.mesh[0]},{self.mesh[1]}|{self.run}"


def base_arch(arch):
    return arch.replace("-smoke", "")


def shapes(case):
    """The (prefill, decode) ``ShapeConfig``s whose rules the run
    installs (only the batch's extent matters to the rules)."""
    if case.run == "long":
        return None, ShapeConfig("long", "decode", case.s_max, 1)
    return (ShapeConfig("prefill", "prefill", case.s, case.b),
            ShapeConfig("decode", "decode", case.s_max, case.b))


def rules(case, shape):
    from repro_torch.launch import steps
    out = dict(treg.RULE_OVERRIDES.get(base_arch(case.arch), {}))
    out.update(steps.shape_rules(shape))
    return out


def tree(arch):
    """The port's seed-0 ``init_params`` draw as numpy (float32
    masters)."""
    return tree_to_numpy(tlm.init_params(
        treg.get(arch), torch.Generator().manual_seed(0), device="cpu"))


def inputs(case):
    """``prompt`` (B, S) int32, ``tokens`` (T, B, 1) int32 and, under
    ``long``, the filled cache tree as numpy (bf16 values as float32);
    for a stub frontend's arch also ``prompt_emb`` (B, S, D) and ``emb``
    (T, B, 1, D), for an enc-dec ``enc_emb`` (B, S, D), float32 (each
    package casts them to bf16)."""
    cfg = treg.get(case.arch)
    rng = np.random.default_rng(case.seed)
    out = {"prompt": rng.integers(0, cfg.vocab, (case.b, case.s),
                                  dtype=np.int32),
           "tokens": rng.integers(0, cfg.vocab, (case.t, case.b, 1),
                                  dtype=np.int32)}
    if cfg.frontend != "none":
        d = cfg.d_model
        out["prompt_emb"] = rng.standard_normal(
            (case.b, case.s, d)).astype(np.float32)
        out["emb"] = rng.standard_normal(
            (case.t, case.b, 1, d)).astype(np.float32)
        if cfg.is_encdec:
            out["enc_emb"] = rng.standard_normal(
                (case.b, case.s, d)).astype(np.float32)
    if case.run == "long":
        whole = tlm.init_caches(cfg, case.b, case.s_max, device="cpu")
        out["cache"] = {k: v for k, v in _flat(whole).items()}
        for k, v in out["cache"].items():
            fill = rng.standard_normal(v.shape).astype(np.float32)
            out["cache"][k] = torch.from_numpy(fill).to(v.dtype).float() \
                .numpy()
    return out


def prefill_batch(cfg, data):
    """The prefill step's batch (numpy): the prompt's tokens, or a stub
    frontend's embeddings (and an enc-dec's encoder embeddings)."""
    if cfg.frontend == "none":
        return {"tokens": data["prompt"]}
    out = {"embeddings": data["prompt_emb"]}
    if cfg.is_encdec:
        out["enc_embeddings"] = data["enc_emb"]
    return out


def decode_batch(cfg, data, i):
    """Decode step ``i``'s batch (numpy): its tokens, or embeddings."""
    if cfg.frontend == "none":
        return {"tokens": data["tokens"][i]}
    return {"embeddings": data["emb"][i]}


def cut_rows(data, rows):
    """The inputs of the batch rows ``rows`` alone (the (T, B, ...)
    decode inputs and the cache along their dim 1)."""
    out = {}
    for k, v in data.items():
        if k == "cache":
            out[k] = {c: x[:, rows] for c, x in v.items()}
        else:
            out[k] = v[:, rows] if k in ("tokens", "emb") else v[rows]
    return out


def _flat(tree_, prefix=""):
    if isinstance(tree_, dict):
        out = {}
        for k, v in tree_.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree_}


def _np(t):
    return t.detach().float().numpy()


def decode_cache(cfg, case, whole):
    """The decode run's whole cache: a prefill's gathered ``whole``
    (attention layers' S positions) copied into ``S_MAX`` positions; a
    Mamba-2 state and an enc-dec's ``cross_kv`` (the encoder's S
    positions) as they are."""
    big = tlm.init_caches(cfg, case.b, case.s_max,
                          enc_len=case.s if cfg.is_encdec else 0,
                          device="cpu")

    def put(dst, src, cross=False):
        for k in dst:
            if isinstance(dst[k], dict):
                put(dst[k], src[k], k == "cross_kv")
            elif dst[k].dim() == 5 and k in ("k", "v") and not cross:
                dst[k][:, :, :src[k].shape[2]] = src[k]
            else:
                dst[k].copy_(src[k])
    put(big, whole)
    return big


def port_run(case, mesh=None, rows=None):
    """The case on this process: under ``mesh`` (the ranks) or with none
    (the (1, 1) steps; ``rows`` a ``slice`` of the batch to run alone).
    Returns numpy: ``prefill`` logits (B, 1, V) gathered, ``cache/<leaf>``
    the gathered caches after prefill, ``logits`` (T, B, 1, V) of the
    decode steps, ``final/<leaf>`` the gathered caches after them, and
    the shard shapes of the caches (``shape/prefill/<leaf>``,
    ``shape/decode/<leaf>``)."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps

    cfg = treg.get(case.arch)
    np_tree, data = tree(case.arch), inputs(case)
    routed = contextlib.ExitStack()
    got_routes = routed.enter_context(mc.routes()) if cfg.is_moe else []
    if rows is not None:
        data = cut_rows(data, rows)
        case = dataclasses.replace(case, b=data["prompt"].shape[0])
    cache_log = tlm.cache_logical_axes(cfg)
    logit_log = {"l": ("batch", None, "vocab")}
    pre, dec = shapes(case)

    def placed(shape):
        if mesh is None:
            return contextlib.nullcontext()
        return sharding.use_mesh(mesh, rules(case, shape))

    def gather(tree_, logical):
        return tree_ if mesh is None else steps.gather_tree(tree_, logical)

    def cut(tree_, logical):
        return tree_ if mesh is None else steps.shard_tree(tree_, logical)

    out = {}
    with placed(pre or dec):
        params = lm_shard_from_jax(np_tree, cfg) if mesh is not None else \
            lm_params_from_jax(np_tree, "cpu", cfg)
        if case.run == "serve":
            logits, caches = steps.make_prefill_step(cfg)(
                params, {k: torch.from_numpy(v) for k, v in
                         prefill_batch(cfg, data).items()})
            out["prefill"] = _np(gather({"l": logits}, logit_log)["l"])
            out.update({f"shape/prefill/{k}": np.asarray(v.shape)
                        for k, v in _flat(caches).items()})
            whole = gather(caches, cache_log)
            out.update({f"cache/{k}": _np(v)
                        for k, v in _flat(whole).items()})
            big = decode_cache(cfg, case, whole)
        else:
            big = tlm.init_caches(cfg, case.b, case.s_max, device="cpu")
            for k, v in _flat(big).items():
                v.copy_(torch.from_numpy(data["cache"][k]))
    start = case.s if case.run == "serve" else case.s_max - case.t
    with placed(dec):
        caches = cut(big, cache_log)
        out.update({f"shape/decode/{k}": np.asarray(v.shape)
                    for k, v in _flat(caches).items()})
        step = steps.make_decode_step(cfg)
        got = []
        for i in range(case.t):
            logits, caches = step(params, {
                k: torch.from_numpy(v) for k, v in
                decode_batch(cfg, data, i).items()}, caches, start + i)
            got.append(_np(gather({"l": logits}, logit_log)["l"]))
        out["logits"] = np.stack(got)
        out.update({f"final/{k}": _np(v) for k, v in
                    _flat(gather(caches, cache_log)).items()})
    routed.close()
    out["routes"] = got_routes
    return out


def _rank(rank, world, case, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        from repro_torch.launch import mesh as meshlib
        mesh = meshlib.make_debug_mesh(*case.mesh, device="cpu")
        out = port_run(case, mesh)
        out["coords"] = mesh.coords
        torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def world(case):
    """The port's four ranks, the JAX subprocess and the port's (1, 1)
    run of one case: ``{"ranks": [...], "jax": {...}, "single": {...}}``
    (numpy)."""
    tmp = tempfile.mkdtemp()
    jax_out = os.path.join(tmp, "jax.npz")
    env = {**os.environ, "XLA_FLAGS":
           "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join(
               [str(HERE), str(HERE.parent / "src"),
                os.environ.get("PYTHONPATH", "")])}
    jax_proc = subprocess.Popen(
        [sys.executable, str(HERE / "torch_serve_mesh_jax.py"), jax_out,
         json.dumps(dataclasses.asdict(case))], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    n = case.mesh[0] * case.mesh[1]
    mp.spawn(_rank, args=(n, case, f"file://{tmp}/rdv", tmp), nprocs=n)
    ranks = [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False)
             for r in range(n)]
    single = shard_by_shard(case) if treg.get(case.arch).is_moe else \
        port_run(case)
    log, _ = jax_proc.communicate()
    assert jax_proc.returncode == 0, log[-3000:]
    with np.load(jax_out) as z:
        jax_res = {k: z[k] for k in z.files}
    return {"case": case, "ranks": ranks, "jax": jax_res, "single": single}


def shard_by_shard(case):
    """The port's (1, 1) steps run on each data shard's rows alone and
    joined: an MoE layer's capacity counts a data shard's tokens (the
    reference's ``t_loc``), so the (1, 1) steps over the whole batch
    route (and drop) other tokens than the mesh does."""
    dp = 1 if shapes(case)[1].global_batch == 1 else case.mesh[0]
    n = case.b // dp
    parts = [port_run(case, rows=slice(d * n, (d + 1) * n))
             for d in range(dp)]
    out = {"routes": [p["routes"] for p in parts]}
    for k, v in parts[0].items():
        if k.startswith(("shape/", "routes")):
            continue
        axis = 0 if k == "prefill" else 1
        out[k] = np.concatenate([p[k] for p in parts], axis=axis)
    return out


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def gaps(got, want):
    """Relative L2 of the prefill logits, of each decode step's logits
    and of every gathered cache leaf (after prefill and after decode)
    of ``got`` against ``want``."""
    out = {}
    if "prefill" in want:
        out["prefill"] = rel(got["prefill"], want["prefill"])
    for i in range(want["logits"].shape[0]):
        out[f"logits/{i}"] = rel(got["logits"][i], want["logits"][i])
    for k in want:
        if k.startswith(("cache/", "final/")):
            out[k] = rel(got[k], want[k])
    return out


def check_same(w):
    """Every rank's gathered logits and caches are bitwise rank 0's (the
    merge of the attention partials runs in rank order on every rank)."""
    r0 = w["ranks"][0]
    keys = [k for k in r0 if k.startswith(("prefill", "logits", "cache/",
                                           "final/"))]
    assert keys
    for r in w["ranks"][1:]:
        for k in keys:
            assert np.array_equal(r[k], r0[k]), k


def check_shapes(w):
    """Every cache leaf's shard on every rank, after prefill and in the
    decode run, has the shape the JAX package's ``NamedSharding`` gives
    ``cache_logical_axes`` under the same rules and mesh; something is
    split."""
    want = {k.split("|", 1)[1]: tuple(int(x) for x in v)
            for k, v in w["jax"].items() if k.startswith("shape|")}
    assert want
    for r in w["ranks"]:
        got = {k: tuple(int(x) for x in r[k]) for k in r
               if k.startswith("shape/")}
        assert got == want, sorted(set(got.items()) ^ set(want.items()))[:6]
    whole = {k.split("/", 1)[1]: v.shape for k, v in w["single"].items()
             if k.startswith("final/")}
    assert any(v != whole[k.split("/", 2)[2]] for k, v in want.items()
               if k.startswith("shape/decode/"))


def check_gaps(w, against, bound):
    """The mesh run's logits and gathered caches within ``bound`` relative
    L2 of the port's (1, 1) steps (``against="single"``) or of the JAX
    mesh steps (``"jax"``); ``bound`` a number, or a ``{substring:
    bound}`` dict whose first entry in a key bounds it (``""`` matches
    every key).  Returns the gaps."""
    want = w["single"] if against == "single" else {
        k: v for k, v in w["jax"].items() if "|" not in k and k != "routes"}
    got = gaps(w["ranks"][0], want)
    over = {k: v for k, v in got.items() if v > (
        bound if not isinstance(bound, dict) else
        next(b for s, b in bound.items() if s in k))}
    assert not over, (over, got)
    return got


def rerouted(w):
    """Per data shard: how many (expert, token) assignments of the mesh
    run's MoE routings (prefill and decode steps, on its first model
    rank) differ from the same shard's (1, 1) run, and how many it
    keeps; every model rank of a data shard routes alike."""
    out = []
    for part, ref in enumerate(w["single"]["routes"]):
        ranks = [r for r in w["ranks"] if len(w["single"]["routes"]) == 1
                 or r["coords"]["data"] == part]
        mine = ranks[0]["routes"]
        assert len(mine) == len(ref) and all(
            all(np.array_equal(a, b) for a, b in zip(mine, r["routes"]))
            for r in ranks)
        out.append((sum(mc.rerouted(a, b) for a, b in zip(mine, ref)),
                    sum(a.size for a in mine)))
    return out
