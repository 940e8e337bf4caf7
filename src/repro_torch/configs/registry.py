"""Registry mapping --arch ids to ArchConfig (+ reduced smoke variants)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig

# ---------------------------------------------------------------------------
# the 10 assigned architectures (exact numbers from the assignment pool)
# ---------------------------------------------------------------------------

JAMBA_1_5_LARGE = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab=65536, head_dim=128,
    n_experts=16, experts_per_token=2, moe_every=2, moe_d_ff=24576,
    attn_every=8, ssm_state=128, ssm_expand=2, ssm_head_dim=128,
    param_dtype="bfloat16", optimizer="adam_int8", train_microbatches=8,
)

MAMBA2_780M = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, head_dim=0,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
)

QWEN3_32B = ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
    train_microbatches=2,
)

LLAMA32_1B = ArchConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab=128256, head_dim=64, rope_theta=5e5,
)

MINICPM_2B = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab=122753, head_dim=64,
)

GEMMA2_2B = ArchConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
    vocab=256000, head_dim=256,
    attn_pattern="local_global", local_window=4096,
    attn_softcap=50.0, final_softcap=30.0,
)

SEAMLESS_M4T_MEDIUM = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256206, head_dim=64, enc_layers=12, frontend="audio",
)

LLAMA4_SCOUT = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, head_dim=128,
    n_experts=16, experts_per_token=1, moe_d_ff=8192, dense_residual=True,
    attn_pattern="chunked", local_window=8192, rope_theta=5e5,
    train_microbatches=4,
)

ARCTIC_480B = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, head_dim=128,
    n_experts=128, experts_per_token=2, moe_d_ff=4864, dense_residual=True,
    param_dtype="bfloat16", optimizer="adam_int8", train_microbatches=4,
)

QWEN2_VL_72B = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, head_dim=128, frontend="vision", rope_theta=1e6,
    param_dtype="bfloat16", optimizer="adam_int8", train_microbatches=4,
)

# beyond-paper performance variants (Sec-Perf hillclimb): pad heads up to
# a TP16-divisible count so attention shards instead of replicating
MINICPM_2B_PADHEADS = dataclasses.replace(
    MINICPM_2B, name="minicpm-2b-padheads",
    n_heads_padded=48, n_kv_heads_padded=48)

GEMMA2_2B_PADHEADS = dataclasses.replace(
    GEMMA2_2B, name="gemma2-2b-padheads",
    n_heads_padded=16, n_kv_heads_padded=16)

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        JAMBA_1_5_LARGE, MAMBA2_780M, QWEN3_32B, LLAMA32_1B, MINICPM_2B,
        GEMMA2_2B, SEAMLESS_M4T_MEDIUM, LLAMA4_SCOUT, ARCTIC_480B,
        QWEN2_VL_72B, MINICPM_2B_PADHEADS, GEMMA2_2B_PADHEADS,
    ]
}

# per-arch sharding rule overrides (heads not divisible by TP=16 -> shard
# only the fused H*hd projection axis and let attention run data-parallel)
RULE_OVERRIDES: dict[str, dict] = {
    "gemma2-2b": {"heads": None, "kv_heads": None},
    "minicpm-2b": {"heads": None, "kv_heads": None},
    "minicpm-2b-padheads": {},     # 48 heads / 16-way TP shards cleanly
    "gemma2-2b-padheads": {},
    "seamless-m4t-medium": {},
    "llama3.2-1b": {"kv_heads": None},
    "qwen3-32b": {"kv_heads": None},
    "llama4-scout-17b-a16e": {"kv_heads": None},
    "arctic-480b": {"kv_heads": None},
    "qwen2-vl-72b": {"kv_heads": None},
    "jamba-1.5-large-398b": {"kv_heads": None},
}


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU smoke tests."""
    pat_len = {"hybrid": 8, "ssm": 1, "dense": 2 if cfg.attn_pattern ==
               "local_global" else 1, "moe": 4 if cfg.attn_pattern ==
               "chunked" else 1, "encdec": 1, "vlm": 1}[cfg.family]
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=pat_len * (2 if pat_len <= 2 else 1),
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        vocab=512,
        n_experts=4 if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2),
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=32,
        local_window=32 if cfg.local_window else 0,
        enc_layers=1 if cfg.enc_layers else 0,
        param_dtype="float32", optimizer="adam", remat=False,
        train_microbatches=1,
        n_heads_padded=0, n_kv_heads_padded=0,
    )


def get(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return reduced(ARCHS[name[: -len("-smoke")]])
    return ARCHS[name]
