"""RecurrentGemma-2B [arXiv:2402.19427; hf] — RG-LRU and local attention,
2:1.

The Griffin pattern ``RRL``: two recurrent blocks per local-MQA block
(window 2048, one KV head); 26 layers = 8 x ``RRL`` + an ``RR`` tail.
"""

from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab_size=256000, head_dim=256, mlp="geglu", norm="rms",
    block_pattern="RRL", sliding_window=2048,
    rglru=RGLRUConfig(lru_width=2560, conv_width=4),
    sharding_profile="sp_seq", subquadratic=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid",
        n_layers=5, d_model=48, n_heads=2, n_kv_heads=1, d_ff=96,
        vocab_size=384, block_pattern="RRL", sliding_window=8,
        rglru=RGLRUConfig(lru_width=48), mlp="geglu", remat="none",
        subquadratic=True)
