"""InternVL2-1B [arXiv:2404.16821; hf] — a ViT frontend (stub) and a dense
GQA backbone (2 KV heads: N = 2 ports of 64 lanes).

The backbone only: 256 precomputed patch embeddings (the data stub's
``patch_embeds``) are prepended to the text tokens.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151655, head_dim=64, mlp="swiglu", norm="rms",
    rope_theta=1_000_000.0, n_patches=256,
    sharding_profile="sp_seq", subquadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=384, n_patches=4, remat="none")
