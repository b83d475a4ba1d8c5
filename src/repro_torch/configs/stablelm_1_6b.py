"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b] — dense MHA (kv=32)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab_size=100352, head_dim=64, mlp="swiglu", norm="ln",
    rope_theta=10_000.0, tie_embeddings=True,
    sharding_profile="tp_heads", subquadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=384, mlp="swiglu", norm="ln", remat="none")
