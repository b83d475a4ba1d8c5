"""Unified model API (port of ``repro.models.api`` for the decoder-only
serving path): ``init_params``, ``prefill_fn``, ``init_cache``,
``decode_fn``, ``greedy_generate``.  ``batch`` carries the VLM's modality
stub, ``patch_embeds``, where the config has one.  Entry points run on
``cuda`` unless ``device="cpu"`` is passed; they raise when no CUDA device
is present."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> lm.LM:
    """Random parameters from a seeded generator on ``device``."""
    return lm.init_params(cfg, seed=seed, device=device)


def _kv_chunk_for(seq: int) -> int:
    return 1024 if seq > 2048 else 0


def prefill_fn(params: lm.LM, batch: dict, cfg: ModelConfig, t_max: int):
    """Prefill ``batch["tokens"] [B, S]`` → ``(logits [B, 1, V], caches)``
    with line-major caches of depth ``t_max``; ``batch["patch_embeds"]
    [B, P, d]`` (an array or a tensor), when given to a VLM config, goes
    before the text."""
    tokens = batch["tokens"]
    patches = batch.get("patch_embeds")
    if patches is not None:
        patches = torch.as_tensor(patches, device=tokens.device)
    return lm.prefill(params, tokens, cfg, t_max, patch_embeds=patches,
                      kv_chunk=_kv_chunk_for(tokens.shape[1]))


def init_cache(cfg: ModelConfig, batch: int, t_max: int, pool_pages: int = 0,
               page_size: int = 0, device=None):
    """Decode-cache tree; ``pool_pages > 0`` backs the full-attention leaves
    with a shared physical page pool."""
    return lm.init_cache(cfg, batch, t_max, pool_pages=pool_pages,
                         page_size=page_size, device=device)


def decode_fn(params: lm.LM, token, caches, pos, cfg: ModelConfig,
              sched=None, page_table=None, page_size: int = 0,
              t_depth: int = 0, live_plan=None, draft: bool = False):
    """One decode step: the per-layer path without ``sched``, the
    burst-scheduled step with a ``BurstScheduler`` (see
    :func:`repro_torch.models.lm.decode_step`).  ``draft`` appends the
    Medusa draft heads' logits (``[B, 1+k, V]``, row 0 the real
    unembedding's)."""
    return lm.decode_step(params, token, caches, pos, cfg, sched=sched,
                          page_table=page_table, page_size=page_size,
                          t_depth=t_depth, live_plan=live_plan, draft=draft)


def greedy_generate(params: lm.LM, prompt: torch.Tensor, cfg: ModelConfig,
                    steps: int, t_max: int, extra=None,
                    on_step=None) -> torch.Tensor:
    """Greedy decoding through the per-layer decode path: prefill
    ``prompt [B, S]`` (with the batch entries ``extra``, e.g. a VLM's
    ``patch_embeds``), feed back the argmax token, and return the
    ``steps`` tokens the decode steps choose, ``[B, steps]`` of the
    prompt's dtype (the prefill's own token is fed in, not returned, as
    the reference).  Decoding starts at position ``S + cfg.n_patches``, as
    the reference's does.  ``on_step(i, logits)``, when given, sees every
    decode step's logits.  Raises when those positions plus ``steps`` do
    not fit in ``t_max``."""
    b = prompt.shape[0]
    s = prompt.shape[1] + (cfg.n_patches or 0)
    if s + steps > t_max:
        raise ValueError(f"prompt of {s} positions + {steps} decode steps "
                         f"does not fit in t_max={t_max}")
    logits, caches = prefill_fn(params, {"tokens": prompt, **(extra or {})},
                                cfg, t_max)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(prompt.dtype)
    out = torch.zeros((b, steps), dtype=prompt.dtype, device=prompt.device)
    for i in range(steps):
        logits, caches = decode_fn(params, tok, caches, s + i, cfg)
        if on_step is not None:
            on_step(i, logits)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(prompt.dtype)
        out[:, i:i + 1] = tok
    return out
