"""Gemma-3-12B [hf:google/gemma-3 family] — 5:1 local:global attention.

Pattern "LLLLLA": five sliding-window (1024) layers per one global layer;
local layers use theta 10k, global layers 1M (128k context recipe).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360,
    vocab_size=262144, head_dim=256, mlp="geglu", norm="rms",
    block_pattern="LLLLLA", sliding_window=1024,
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    sharding_profile="tp_heads", subquadratic=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
        vocab_size=512, head_dim=16, mlp="geglu", block_pattern="LLLLLA",
        sliding_window=8, rope_theta_global=1_000_000.0, remat="none",
        subquadratic=True)
