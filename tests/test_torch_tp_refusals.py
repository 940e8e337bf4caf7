"""What the port does not place refuses a mesh that splits a
tensor-parallel, sequence, FSDP or (outside training) cache-sequence
axis, naming ROADMAP section 1, item 2: a page pool, which has no
logical axes (nor in the reference) -- the paged prefill step (at
construction) and ``lm.forward`` on a page pool.  The mesh is a (2, 2)
grid of axis extents alone: every refusal comes before any collective.
Under the overrides that unmap every axis but ``batch`` and ``experts``
nothing is refused.  Every family's training, prefill and decode steps
on dense caches are placed (``tests/test_torch_tp_*.py``,
``tests/test_torch_serve_mesh_*.py``)."""
import types

import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_ep_cases as ec
from repro_torch.configs import registry as treg
from repro_torch.distributed import sharding
from repro_torch.launch import steps
from repro_torch.models import lm
from torch_threads import _one_torch_thread  # noqa: F401

GRID = types.SimpleNamespace(axis_names=("data", "model"),
                             shape={"data": 2, "model": 2})
ITEM = "ROADMAP section 1, item 2"
MAKERS = (steps.make_paged_prefill_step,)


@pytest.mark.parametrize("make", MAKERS, ids=lambda f: f.__name__)
def test_serving_steps_refuse_a_split_mesh(make):
    cfg = treg.get("llama3.2-1b-smoke")
    with sharding.use_mesh(GRID):
        with pytest.raises(ValueError, match=ITEM):
            make(cfg)
    with sharding.use_mesh(GRID, {"heads_flat": None, "mlp": None,
                                  "vocab": None, "act_seq": None,
                                  "w_embed": "data"}):
        with pytest.raises(ValueError, match="w_embed"):
            make(cfg)
    with sharding.use_mesh(GRID, {**ec.EP_RULES, "kv_seq": "data"}):
        with pytest.raises(ValueError, match="kv_seq"):
            make(cfg)
    with sharding.use_mesh(GRID, ec.EP_RULES):
        assert callable(make(cfg))


def test_forward_on_a_page_pool_refuses_a_split_mesh():
    cfg = treg.get("llama3.2-1b-smoke")
    params = lm.init_params(cfg, device="meta")
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.int32)}
    tables = torch.zeros((4, 2), dtype=torch.int32)
    for mode in ("prefill", "decode"):
        with sharding.use_mesh(GRID), pytest.raises(
                ValueError, match=f"page pool.*{ITEM}"):
            lm.forward(cfg, params, batch, mode=mode, tables=tables,
                       pos=torch.zeros(4, dtype=torch.int32))
