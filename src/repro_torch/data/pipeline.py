"""Deterministic synthetic data (port of ``repro.data.pipeline``'s
``SyntheticLM``; numpy only, so its batches are the reference's bit for
bit).

Tokens follow a fixed random bigram chain drawn from the seed, and a batch
is a pure function of ``(seed, step, host)``.  A VLM config's batch also
carries its modality stub: ``n_patches`` precomputed patch embeddings,
drawn after the tokens, and ``seq - n_patches`` text tokens; an audio
config's carries ``frames``, the ``encoder_seq`` frame embeddings the conv
frontend would produce, drawn last.  :func:`batch_lines` stages a token
batch as fabric lines and :func:`make_batch_specs` describes a step's
inputs without allocating them.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class SyntheticLM:
    cfg: ModelConfig
    batch: int                      # per-host batch
    seq: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    branching: int = 4              # bigram fan-out
    vocab_limit: int = 0            # draw tokens from [0, limit) (0 = full)

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        v = self.vocab_limit or self.cfg.vocab_size
        self._v = v
        self._table = rng.randint(0, v, size=(v, self.branching))

    def batch_at(self, step: int) -> dict:
        """The batch for a given global step (pure function — resumable)."""
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step) * 31 + self.host_id)
        v = self._v
        b, s = self.batch, self.seq
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.randint(0, v, size=b)
        choices = rng.randint(0, self.branching, size=(b, s))
        for t in range(s):
            toks[:, t + 1] = self._table[toks[:, t], choices[:, t]]
        out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if self.cfg.n_patches:
            # n_patches stub patch embeddings + (s - n_patches) text tokens
            text = s - self.cfg.n_patches
            out["patch_embeds"] = rng.randn(
                b, self.cfg.n_patches, self.cfg.d_model).astype(np.float32)
            out["tokens"] = toks[:, :text]
            out["targets"] = toks[:, 1:text + 1]
        if self.cfg.family == "audio":
            out["frames"] = rng.randn(
                b, self.cfg.encoder_seq, self.cfg.d_model).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def batch_lines(tokens: np.ndarray, n_ports: int) -> np.ndarray:
    """Pack a ``[B, S]`` token batch into fabric DRAM lines ``[L, N]``: the
    flattened batch zero-padded to whole N-line groups (L a multiple of N),
    one N-word line per row, so it can ride the shared read network as one
    more logical stream.  The consumer slices ``B*S`` tokens back off."""
    flat = np.asarray(tokens).reshape(-1)
    group = n_ports * n_ports
    pad = (-flat.size) % group
    if pad:
        flat = np.concatenate([flat, np.zeros((pad,), flat.dtype)])
    return flat.reshape(-1, n_ports)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one step input (no storage)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def make_batch_specs(cfg: ModelConfig, batch: int, seq: int,
                     kind: str = "train") -> dict:
    """:class:`TensorSpec` stand-ins for every model input of a step
    (``kind``: train, prefill or decode): the text tokens (and targets)
    after a VLM's patches, the patch embeddings and an audio config's
    frames, in float32 as the data stub draws them."""
    text = seq - (cfg.n_patches or 0) if kind != "decode" else seq
    specs = {}
    if kind == "train":
        specs["tokens"] = TensorSpec((batch, text), torch.int32)
        specs["targets"] = TensorSpec((batch, text), torch.int32)
    elif kind == "prefill":
        specs["tokens"] = TensorSpec((batch, text), torch.int32)
    if cfg.n_patches and kind != "decode":
        specs["patch_embeds"] = TensorSpec(
            (batch, cfg.n_patches, cfg.d_model), torch.float32)
    if cfg.family == "audio" and kind != "decode":
        specs["frames"] = TensorSpec(
            (batch, cfg.encoder_seq, cfg.d_model), torch.float32)
    return specs
