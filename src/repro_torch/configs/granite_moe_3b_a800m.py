"""Granite-3.0-3B-A800M MoE [hf:ibm-granite] — 40 experts top-8, 8 KV
heads (N = 8 ports, a 1536-wide activation row is 8 frames of 192)."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49155, head_dim=64, mlp="swiglu", norm="rms",
    moe=MoEConfig(n_experts=40, top_k=8, expert_d_ff=512),
    sharding_profile="moe_cap", subquadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab_size=256, moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=64),
        remat="none")
