"""Architecture + run configuration dataclasses and the input-shape table."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # --- attention flavour ---
    qk_norm: bool = False
    attn_softcap: float = 0.0          # gemma2 attention-logit softcap
    final_softcap: float = 0.0         # gemma2 final-logit softcap
    local_window: int = 0              # window for local/chunked attention
    attn_pattern: str = "full"         # full | local_global | chunked
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1                 # MoE on every k-th layer
    dense_residual: bool = False       # dense FFN in parallel with MoE
    moe_d_ff: int = 0                  # expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    attn_every: int = 0                # jamba: 1 attention layer per N
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    # --- encoder-decoder ---
    enc_layers: int = 0
    # --- modality frontend stub ---
    frontend: str = "none"             # none | audio | vision
    # --- numerics / scale ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: str = "float32"       # master weights
    optimizer: str = "adam"            # adam | adam_int8
    remat: bool = True
    train_microbatches: int = 1        # grad-accumulation microbatches
    # pad attention heads up to a TP-divisible count (dummy heads; exact
    # when the extra wo rows are zero) -- used by the -padheads variants
    n_heads_padded: int = 0
    n_kv_heads_padded: int = 0
    # --- technique integration (the paper's search) ---
    mps_precisions: tuple[int, ...] = (0, 2, 4, 8)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.ssm_state > 0 and self.attn_every == 0

    @property
    def is_hybrid(self) -> bool:
        return self.ssm_state > 0 and self.attn_every > 0

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Supports long_500k (attention-free / mostly-SSM / chunked)."""
        return self.is_ssm or self.is_hybrid or self.attn_pattern == "chunked"

    @property
    def h_eff(self) -> int:
        return self.n_heads_padded or self.n_heads

    @property
    def hkv_eff(self) -> int:
        return self.n_kv_heads_padded or self.n_kv_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch x shape) a runnable cell? Returns (ok, reason-if-not)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention architecture; long_500k "
                       "mandates sub-quadratic attention (DESIGN.md skip "
                       "list)")
    return True, ""
