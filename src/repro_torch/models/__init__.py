"""Models of the port: the decoder-only LM (dense, MoE, VLM, RG-LRU hybrid
and Mamba-2) on the serving path."""

from repro_torch.models.api import (decode_fn, init_cache, init_params,
                                    prefill_fn)

__all__ = ["init_params", "prefill_fn", "decode_fn", "init_cache"]
