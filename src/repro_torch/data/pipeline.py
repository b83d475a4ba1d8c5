"""Deterministic synthetic data (port of ``repro.data.pipeline``'s
``SyntheticLM``; numpy only, so its batches are the reference's bit for
bit).

Tokens follow a fixed random bigram chain drawn from the seed, and a batch
is a pure function of ``(seed, step, host)``.  A VLM config's batch also
carries its modality stub: ``n_patches`` precomputed patch embeddings,
drawn after the tokens, and ``seq - n_patches`` text tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

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
        if self.cfg.family == "audio":
            raise NotImplementedError(
                "the audio modality stub comes with whisper's slice "
                "(ROADMAP §1 item 7)")
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
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
