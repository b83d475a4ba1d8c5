"""Models of the port: the decoder-only LM (dense, MoE, VLM, RG-LRU hybrid
and Mamba-2) and the whisper encoder-decoder, for serving and training."""

from repro_torch.models.api import (decode_fn, init_cache, init_params,
                                    loss_fn, prefill_fn)

__all__ = ["init_params", "loss_fn", "prefill_fn", "decode_fn", "init_cache"]
