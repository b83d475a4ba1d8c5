"""StarCoder2-15B [arXiv:2402.19173; hf] — dense GQA + RoPE code LM."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_ff=24576,
    vocab_size=49152, head_dim=128, mlp="gelu", norm="ln",
    rope_theta=100_000.0, tie_embeddings=True,
    sharding_profile="tp_heads", subquadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, mlp="gelu", norm="ln", remat="none")
