"""The least work the window's tokens need, from a configuration's widths.

Both numbers are the model's and not the program's: they count the same
work whatever moves it, so a change that moves fewer bytes or does fewer
operations for the same tokens shows as a higher share.

- Operations: every prompt token pays the layers' matrix products (2 per
  weight) and causal attention over the keys up to itself (QK^T and PV,
  2 operations each per key and channel); the unembedding is paid once per
  sequence the prefill scores (its last position) and once per decoded
  token.  Embedding lookups, norms and softmax are not counted.
- HBM bytes: a prefill reads the weights once and writes the prompt's K/V;
  a decode step reads the weights once, reads every cached K/V byte of the
  sequences it advances once, and writes their new K/V.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class Widths:
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    gated: bool
    tied: bool
    dtype_bytes: int = 2

    @property
    def layer_weights(self) -> int:
        """Weights of one layer's matrix products."""
        attn = self.d_model * self.head_dim * (2 * self.heads
                                               + 2 * self.kv_heads)
        mlp = (3 if self.gated else 2) * self.d_model * self.d_ff
        return attn + mlp

    @property
    def head_weights(self) -> int:
        return self.vocab * self.d_model

    @property
    def weight_bytes(self) -> int:
        """Every weight once: the layers, the embedding table, a separate
        head when it is not tied (norms are a rounding error and left
        out)."""
        tables = self.head_weights * (1 if self.tied else 2)
        return (self.layers * self.layer_weights + tables) * self.dtype_bytes

    @property
    def kv_bytes_per_token(self) -> int:
        return (2 * self.layers * self.kv_heads * self.head_dim
                * self.dtype_bytes)

    def attn_flops(self, keys: int) -> int:
        """Attention operations of one query over ``keys`` keys, all
        layers."""
        return 4 * self.layers * self.heads * self.head_dim * keys


DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def widths(cfg: dict) -> Widths:
    """The widths of a configuration file (the source's key names)."""
    d = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    return Widths(
        layers=cfg["num_hidden_layers"], d_model=d, heads=heads,
        kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or d // heads,
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        gated=cfg["reference"]["mlp"] == "silu_gated",
        tied=bool(cfg["tie_word_embeddings"]),
        dtype_bytes=DTYPE_BYTES[cfg["torch_dtype"]])


def prefill_flops(w: Widths, prompt: int) -> int:
    """One prompt of ``prompt`` tokens: the layers for every token, causal
    attention (token ``p`` attends ``p + 1`` keys), one head product."""
    return (2 * w.layers * w.layer_weights * prompt
            + w.attn_flops(prompt * (prompt + 1) // 2)
            + 2 * w.head_weights)


def decode_flops(w: Widths, keys: int) -> int:
    """One decoded token attending ``keys`` keys (itself included)."""
    return (2 * w.layers * w.layer_weights + w.attn_flops(keys)
            + 2 * w.head_weights)


def prefill_bytes(w: Widths, prompt: int) -> int:
    return w.weight_bytes + prompt * w.kv_bytes_per_token


def decode_step_bytes(w: Widths, cached: Iterable[int]) -> int:
    """One decode step advancing sequences whose caches hold ``cached``
    positions each: the weights once, every cached K/V read, each new
    token's K/V written."""
    cached = list(cached)
    if not cached:
        return 0
    return (w.weight_bytes
            + (sum(cached) + len(cached)) * w.kv_bytes_per_token)
