"""Unified model API (port of ``repro.models.api``): ``init_params``,
``loss_fn``, ``prefill_fn``, ``init_cache``, ``decode_fn``,
``greedy_generate``, the same entry points for every family (the
decoder-only LM of :mod:`repro_torch.models.lm`, the encoder-decoder of
:mod:`repro_torch.models.whisper`).  ``batch`` carries the modality stubs
where the config has one: ``patch_embeds`` (VLM) and ``frames`` (audio),
as arrays or tensors.  Entry points run on ``cuda`` unless
``device="cpu"`` is passed; they raise when no CUDA device is present."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import lm, whisper
from repro_torch.models.moe import aux_load_balance_loss


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random parameters from a seeded generator on ``device``: an
    :class:`repro_torch.models.lm.LM`, or for the audio family a
    :class:`repro_torch.models.whisper.Whisper`."""
    if cfg.family == "audio":
        return whisper.init_params(cfg, seed=seed, device=device)
    return lm.init_params(cfg, seed=seed, device=device)


def _kv_chunk_for(seq: int) -> int:
    return 1024 if seq > 2048 else 0


def _stub(batch: dict, name: str, device):
    """The modality stub ``batch[name]`` as a tensor on ``device`` (or
    None)."""
    x = batch.get(name)
    return None if x is None else torch.as_tensor(x, device=device)


def loss_fn(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["targets"]`` (a VLM's over its text positions only), plus, for
    a MoE config, ``0.01`` times the load-balance loss of the first MoE
    layer's router on the token embeddings (the reference's cheap
    proxy)."""
    tokens = batch["tokens"]
    kv_chunk = _kv_chunk_for(tokens.shape[1])
    if cfg.family == "audio":
        logits = whisper.forward(params, tokens,
                                 _stub(batch, "frames", tokens.device), cfg,
                                 kv_chunk=kv_chunk)
    else:
        patches = _stub(batch, "patch_embeds", tokens.device)
        logits = lm.forward(params, tokens, cfg, patch_embeds=patches,
                            kv_chunk=kv_chunk)
        if cfg.n_patches and patches is not None:
            logits = logits[:, cfg.n_patches:]   # loss over text positions
    loss = cm.softmax_xent(logits, batch["targets"], cfg.vocab_size)
    if cfg.moe is not None:
        x = cm.embed_apply(params.embed, tokens)
        first = params.unit[0][0] if len(params.unit) else params.tail[0]
        loss = loss + 0.01 * aux_load_balance_loss(first.ffn, x, cfg)
    return loss


def prefill_fn(params, batch: dict, cfg: ModelConfig, t_max: int):
    """Prefill ``batch["tokens"] [B, S]`` → ``(logits [B, 1, V], caches)``
    with line-major caches of depth ``t_max``; ``batch["patch_embeds"]
    [B, P, d]``, when given to a VLM config, goes before the text;
    ``batch["frames"]`` is an audio config's encoder input."""
    tokens = batch["tokens"]
    if cfg.family == "audio":
        return whisper.prefill(params, tokens,
                               _stub(batch, "frames", tokens.device), cfg,
                               t_max)
    return lm.prefill(params, tokens, cfg, t_max,
                      patch_embeds=_stub(batch, "patch_embeds",
                                         tokens.device),
                      kv_chunk=_kv_chunk_for(tokens.shape[1]))


def init_cache(cfg: ModelConfig, batch: int, t_max: int, pool_pages: int = 0,
               page_size: int = 0, device=None):
    """Decode-cache tree; ``pool_pages > 0`` backs the full-attention leaves
    with a shared physical page pool (decoder-only families)."""
    if cfg.family == "audio":
        if pool_pages:
            raise ValueError("the paged pool covers decoder-only families")
        return whisper.init_cache(cfg, batch, t_max, device=device)
    return lm.init_cache(cfg, batch, t_max, pool_pages=pool_pages,
                         page_size=page_size, device=device)


def decode_fn(params, token, caches, pos, cfg: ModelConfig,
              sched=None, page_table=None, page_size: int = 0,
              t_depth: int = 0, live_plan=None, shard_plans=None,
              draft: bool = False):
    """One decode step: the per-layer path without ``sched``, the
    burst-scheduled step with a ``BurstScheduler`` (see
    :func:`repro_torch.models.lm.decode_step`); ``shard_plans`` lowers the
    fused sparse bursts over the sharded pool.  ``draft`` appends the
    Medusa draft heads' logits (``[B, 1+k, V]``, row 0 the real
    unembedding's).  The audio family takes the per-layer path only."""
    if cfg.family == "audio":
        if sched is not None or page_table is not None or draft \
                or shard_plans is not None:
            raise ValueError("the burst-scheduled step, the paged pool and "
                             "draft heads cover decoder-only families")
        return whisper.decode_step(params, token, caches, pos, cfg)
    return lm.decode_step(params, token, caches, pos, cfg, sched=sched,
                          page_table=page_table, page_size=page_size,
                          t_depth=t_depth, live_plan=live_plan,
                          shard_plans=shard_plans, draft=draft)


def greedy_generate(params, prompt: torch.Tensor, cfg: ModelConfig,
                    steps: int, t_max: int, extra=None,
                    on_step=None) -> torch.Tensor:
    """Greedy decoding through the per-layer decode path: prefill
    ``prompt [B, S]`` (with the batch entries ``extra``: a VLM's
    ``patch_embeds``, an audio config's ``frames``), feed back the argmax
    token, and return the ``steps`` tokens the decode steps choose, ``[B,
    steps]`` of the prompt's dtype (the prefill's own token is fed in, not
    returned, as the reference).  Decoding starts at position ``S +
    cfg.n_patches``, as the reference's does.  ``on_step(i, logits)``,
    when given, sees every decode step's logits.  Raises when those
    positions plus ``steps`` do not fit in ``t_max``."""
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
