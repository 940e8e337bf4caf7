"""What the port does not place yet refuses a mesh that splits a
tensor-parallel, sequence or FSDP axis, naming ROADMAP section 1, items
2-3: the prefill, paged prefill and decode steps (at construction) and
``lm.forward`` outside the training step, and the training step of the
enc-dec, VLM and hybrid families.  The mesh is a (2, 2) grid of axis
extents alone: every refusal comes before any collective.  Under the
overrides that unmap every axis but ``batch`` and ``experts`` nothing is
refused."""
import types

import pytest

torch = pytest.importorskip("torch")  # the port's optional dependency

import torch_ep_cases as ec
from repro_torch.configs import registry as treg
from repro_torch.data import synthetic
from repro_torch.distributed import sharding
from repro_torch.launch import steps
from repro_torch.models import lm
from torch_threads import _one_torch_thread  # noqa: F401

GRID = types.SimpleNamespace(axis_names=("data", "model"),
                             shape={"data": 2, "model": 2})
ITEM = "ROADMAP section 1, items 2-3"
MAKERS = (steps.make_prefill_step, steps.make_paged_prefill_step,
          steps.make_decode_step)


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
    with sharding.use_mesh(GRID, ec.EP_RULES):
        assert callable(make(cfg))


def test_forward_outside_training_refuses_a_split_mesh():
    cfg = treg.get("llama3.2-1b-smoke")
    params = lm.init_params(cfg, device="meta")
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.int32)}
    for kw in (dict(mode="prefill"), dict(mode="train",
                                          logits_mode="full")):
        with sharding.use_mesh(GRID), pytest.raises(ValueError, match=ITEM):
            lm.forward(cfg, params, batch, **kw)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium-smoke",
                                  "qwen2-vl-72b-smoke",
                                  "jamba-1.5-large-398b-smoke"])
def test_training_step_of_other_families_refuses_a_split_mesh(arch):
    cfg = treg.get(arch)
    params = lm.init_params(cfg, device="meta", mps_on=True)
    batch = synthetic.lm_batch(cfg.vocab, 33, 4, 0)
    with sharding.use_mesh(GRID), pytest.raises(ValueError, match=(
            f"the {cfg.family} family's training step.*{ITEM}")):
        lm.loss_fn(cfg, params, batch)
