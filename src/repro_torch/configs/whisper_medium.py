"""Whisper-medium [arXiv:2212.04356] — encoder-decoder; conv frontend STUB.

24 encoder + 24 decoder layers, d_model 1024, MHA (kv=16), LayerNorm, GeLU.
The batch supplies the 1500 precomputed frame embeddings the conv
downsampler would produce (``frames``).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=51865, head_dim=64, mlp="gelu", norm="ln",
    encoder_layers=24, encoder_seq=1500, tie_embeddings=True,
    sharding_profile="tp_heads", subquadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        n_layers=2, d_model=48, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab_size=256, mlp="gelu", norm="ln",
        encoder_layers=2, encoder_seq=8, remat="none")
