"""Gemma-3-4B [hf:google/gemma-3 family] — 5:1 local:global, 34 layers.

8 heads cannot split a 16-way model axis → sequence-parallel profile.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
    vocab_size=262144, head_dim=256, mlp="geglu", norm="rms",
    block_pattern="LLLLLA", sliding_window=1024,
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    sharding_profile="sp_seq", subquadratic=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b-smoke", family="dense",
        n_layers=8, d_model=48, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=384, head_dim=16, mlp="geglu", block_pattern="LLLLLA",
        sliding_window=8, rope_theta_global=1_000_000.0, remat="none",
        subquadratic=True)
