"""Mamba2-780M [arXiv:2405.21060] — attention-free SSD (state-space
duality): 48 ``M`` blocks, no KV cache."""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=50280, block_pattern="M",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    mlp="gelu", norm="rms",
    sharding_profile="tp_heads", subquadratic=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=3, d_model=64, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab_size=384, block_pattern="M",
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=8),
        remat="none", subquadratic=True)
