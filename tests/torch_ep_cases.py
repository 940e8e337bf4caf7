"""What ``tests/test_torch_expert_parallel.py`` and its JAX subprocess
(``tests/torch_ep_jax.py``) share: the MoE layer cases, drawn the same
way on both sides.

A case is one registry MoE arch's smoke MoE layer (super-block 0 of the
MoE slot ``SLOT[arch]``: arctic's top-2 with the shared FFN, scout's
top-1 with the shared FFN, jamba's top-2 without it) with its searched
gammas, its weights in float32 or bf16, a bf16 input of ``B x S`` tokens
and a float32 cotangent, all from seeds.  The weights are the port's
``init_params(mps_on=True)`` draw from seed 0 carried as numpy.
"""
import numpy as np
import torch

from repro_torch.bridge import tree_to_numpy
from repro_torch.configs import registry as treg
from repro_torch.distributed import sharding as tsh
from repro_torch.models import lm as tlm

# the rule overrides that unmap every axis but ``batch`` and ``experts``:
# the expert-parallel layout alone, which the expert-parallel suites hold
# (the reference's override mechanism, ``sharding.use_mesh(mesh, rules)``)
EP_RULES = {a: None for a in tsh.DEFAULT_RULES
            if a not in ("batch", "experts")}

SLOT = {"arctic-480b-smoke": "l0", "llama4-scout-17b-a16e-smoke": "l0",
        "jamba-1.5-large-398b-smoke": "l1"}
DTYPES = ("float32", "bfloat16")
MESHES = ((1, 2), (1, 4), (2, 2))
B, S = 4, 8


def case(arch: str, dtype: str):
    """``(ffn tree, x, ct)`` as numpy: the layer's parameters (gammas
    float32, the rest ``dtype``), the input (float32 values of bf16
    numbers) and the cotangent."""
    import ml_dtypes
    cfg = treg.get(arch)
    tree = tree_to_numpy(tlm.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu", mps_on=True))
    ffn = _first(tree["blocks"][SLOT[arch]]["ffn"])
    if dtype == "bfloat16":
        ffn = _cast(ffn, ml_dtypes.bfloat16)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(ml_dtypes.bfloat16)
    ct = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32) * 0.01
    return ffn, x.astype(np.float32), ct


def logical(arch: str) -> dict:
    """The layer's logical axes (``lm.logical_axes`` of its slot, the
    super-block axis dropped)."""
    tree = tlm.logical_axes(treg.get(arch), mps_on=True)
    return _first(tree["blocks"][SLOT[arch]]["ffn"], axes=True)


def _first(tree, axes=False):
    if isinstance(tree, dict):
        return {k: _first(v, axes) for k, v in tree.items()}
    return tree[1:] if axes else np.asarray(tree[0])


def _cast(tree, dt):
    return {k: _cast(v, dt) if isinstance(v, dict) else
            (v if k == "gamma" else v.astype(dt)) for k, v in tree.items()}


def flat(tree, prefix=""):
    """``{"a/b": float32 numpy}`` of a nested dict of arrays / tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    if torch.is_tensor(tree):
        return {prefix[:-1]: tree.detach().float().numpy()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
