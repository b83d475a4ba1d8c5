"""Kimi-K2 1T-A32B [arXiv:2501 (paper-table)] — trillion-parameter MoE,
61 layers, 384 experts top-8, GQA kv=8.

About 1.04 T parameters (2 TB in bf16) fit no single 80 GB card: the port
serves only :func:`smoke`; ``CONFIG`` is there for ``--arch``,
``param_count`` and field parity with the reference, and is never
allocated."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163840, head_dim=128, mlp="swiglu", norm="rms",
    moe=MoEConfig(n_experts=384, top_k=8, expert_d_ff=2048),
    rope_theta=50_000.0,
    sharding_profile="tp_heads", subquadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke", family="moe",
        n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab_size=256, moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=32),
        remat="none")
