"""Decoder-only LM (port of ``repro.models.lm``): full-attention ``A``
and sliding-window ``L`` blocks, each with a dense MLP or, when
``cfg.moe`` is set, the MoE FFN of :mod:`repro_torch.models.moe`; RG-LRU
``R`` blocks (:mod:`repro_torch.models.rglru`) with the same FFN; and
Mamba-2 ``M`` blocks (:mod:`repro_torch.models.mamba2`), a mixer with no
FFN.  Parameters, caches, the training forward, prefill (with a VLM's
patch-embedding prefix), the per-layer decode step (over dense caches or,
gathered, over the page pool), the burst-scheduled decode step (with
``serve_fsdp`` weight streaming), and the Medusa draft heads any decode
step can append.

Parameters are an :class:`LM` module: one :class:`Block` per layer
(``LM.unit[i][r]`` is pattern position ``i`` of repetition ``r``, the
reference's stacked ``unit`` axis split into modules; ``LM.tail[i]`` the
remainder layers).  Weights keep the reference's ``[d_in, d_out]``
orientation (``x @ w``).  The layer scan is a Python loop.

Caches keep the reference's tree layout, stacked over layers:
``{"unit": [{"k": [reps, ...], "v": ...}], "tail": [...]}`` — a paged pool
leaf is ``[reps, n_pages, page_size, Hkv, D]``, a sliding-window layer's
ring ``[reps, B, min(t_max, window), Hkv, D]``, an ``R`` block's ``{"conv":
[reps, B, K-1, W], "h": [reps, B, W]}``, an ``M`` block's ``{"conv": [reps,
B, K-1, C], "state": [reps, B, H, P, N]}`` (``h`` and ``state`` float32 in
any model dtype) — so the scheduler's streams, index tiling and counters
match the reference one for one.  The decode steps write each new token's
K/V and each new recurrent state into the caches in place (the reference
returns new arrays); the returned tree holds the same leaves.
"""

from __future__ import annotations

import contextlib
import math
import types

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import mamba2, moe, rglru


def pattern_unit(cfg: ModelConfig):
    pat = cfg.block_pattern
    reps = cfg.n_layers // len(pat)
    tail = pat[: cfg.n_layers - reps * len(pat)]
    return pat, reps, tail


# ----------------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------------

def _params(shapes: dict, dtype, device) -> nn.ParameterDict:
    return _typed_params({name: (shape, dtype)
                          for name, shape in shapes.items()}, device)


def _typed_params(shapes: dict, device) -> nn.ParameterDict:
    """``{name: (shape, dtype)}`` → uninitialised parameters, each leaf in
    its own dtype (a float32 router, gate or state parameter in a bf16
    model)."""
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                           requires_grad=False)
        for name, (shape, dt) in shapes.items()})


def _norm(cfg: ModelConfig, dtype, device) -> nn.ParameterDict:
    shapes = {"scale": (cfg.d_model,)}
    if cfg.norm != "rms":
        shapes["bias"] = (cfg.d_model,)
    return _params(shapes, dtype, device)


class Block(nn.Module):
    """One decoder layer of type ``t``, pre-norm: attention (``A`` or
    ``L``; the two have the same parameters, ``attn``) or the RG-LRU block
    (``R``, ``rec``), then the MLP, or the MoE FFN when ``cfg.moe`` is set
    (its router in float32 whatever the model dtype); or the Mamba-2 mixer
    alone (``M``, ``mixer``: no ``norm2``, no FFN)."""

    def __init__(self, t: str, cfg: ModelConfig, dtype, device):
        super().__init__()
        hd, d = cfg.resolved_head_dim, cfg.d_model
        self.norm1 = _norm(cfg, dtype, device)
        if t in ("A", "L"):
            self.attn = _params({"wq": (d, cfg.n_heads * hd),
                                 "wk": (d, cfg.n_kv_heads * hd),
                                 "wv": (d, cfg.n_kv_heads * hd),
                                 "wo": (cfg.n_heads * hd, d)}, dtype, device)
        elif t == "R":
            self.rec = _typed_params(rglru.rglru_param_shapes(cfg, dtype),
                                     device)
        elif t == "M":
            self.mixer = _typed_params(
                mamba2.mamba_param_shapes(cfg, dtype), device)
            return
        else:
            raise ValueError(f"unknown block type {t!r}")
        self.norm2 = _norm(cfg, dtype, device)
        if cfg.moe is not None:
            self.ffn = _typed_params(moe.moe_param_shapes(cfg, dtype), device)
            return
        ffn = {"w_up": (d, cfg.d_ff), "w_out": (cfg.d_ff, d)}
        if cfg.mlp in ("swiglu", "geglu"):
            ffn["w_gate"] = (d, cfg.d_ff)
        self.ffn = _params(ffn, dtype, device)


def _block_parts(block) -> list:
    """A block's parameter groups in the reference tree's sorted key order
    (``attn, ffn, norm1, norm2``; ``ffn, norm1, norm2, rec``; ``mixer,
    norm1``), of a :class:`Block` or of a decode step's copy of one."""
    if isinstance(block, nn.Module):
        return sorted(name for name, _ in block.named_children())
    return sorted(vars(block))


class LM(nn.Module):
    """The decoder's parameters (uninitialised; see :func:`init_params` and
    :func:`repro_torch.convert.params_from_jax`)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dtype = cfg.param_dtype
        unit, reps, tail = pattern_unit(cfg)
        embed = {"table": (cm.pad_vocab(cfg.vocab_size), cfg.d_model)}
        if not cfg.tie_embeddings:
            embed["head"] = (cfg.d_model, cm.pad_vocab(cfg.vocab_size))
        self.embed = _params(embed, dtype, device)
        self.unit = nn.ModuleList(
            nn.ModuleList(Block(t, cfg, dtype, device) for _ in range(reps))
            for t in (unit if reps > 0 else ""))
        self.tail = nn.ModuleList(Block(t, cfg, dtype, device) for t in tail)
        self.final_norm = _norm(cfg, dtype, device)
        # Medusa draft heads (``cfg.spec_heads``): {"w": [k, d, d]}, or None
        self.draft = (_params({"w": (cfg.spec_heads, cfg.d_model,
                                     cfg.d_model)}, dtype, device)
                      if cfg.spec_heads else None)


def with_draft(params: LM, draft: dict) -> LM:
    """An :class:`LM` sharing ``params``' layers whose draft heads are
    ``draft`` (``{"w": [k, d, d]}``); ``params`` itself is not changed."""
    out = LM.__new__(LM)
    nn.Module.__init__(out)
    out.embed, out.final_norm = params.embed, params.final_norm
    out.unit, out.tail = params.unit, params.tail
    out.draft = nn.ParameterDict({
        name: nn.Parameter(t, requires_grad=False)
        for name, t in draft.items()})
    return out


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """Random parameters on ``device`` from a seeded ``torch.Generator``:
    truncated normals scaled like the reference (``1/sqrt(d_in)`` for
    projections, ``1/sqrt(d_model)`` for the embedding), norms at their
    identity; the draft heads (``cfg.spec_heads``) like a projection; the
    RG-LRU and Mamba-2 parts as :func:`repro_torch.models.rglru.
    rglru_init_` and :func:`repro_torch.models.mamba2.mamba_init_` fill
    them.  The numbers are not the reference's ``jax.random`` draws.  On
    the ``meta`` device the parameters have their shapes and no values."""
    dev = resolve_device(device)
    params = LM(cfg, dev)
    if dev.type == "meta":           # shapes alone
        return params
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for block in params.modules():
        if isinstance(block, Block) and hasattr(block, "rec"):
            rglru.rglru_init_(block.rec, gen)
        elif isinstance(block, Block) and hasattr(block, "mixer"):
            mamba2.mamba_init_(block.mixer, gen)
    for name, p in params.named_parameters():
        part, leaf = name.split(".")[-2:]
        if part in ("rec", "mixer"):
            continue
        if leaf in ("scale", "bias"):
            p.fill_(1.0 if (leaf == "scale" and cfg.norm != "rms") else 0.0)
            continue
        # [V, d] table, [d_in, d_out] projections, [k, d_in, d_out] heads
        fan_in = p.shape[1] if leaf == "table" else p.shape[-2]
        p.copy_(cm.trunc_normal(gen, p.shape, dev, 1.0 / math.sqrt(fan_in)))
    return params


def _layers(params: LM, cfg: ModelConfig):
    """``(type, kind, index, rep, block)`` for every layer in execution
    order (``rep`` is None for tail layers)."""
    unit, reps, tail = pattern_unit(cfg)
    for r in range(reps):
        for i, t in enumerate(unit):
            yield t, "unit", i, r, params.unit[i][r]
    for i, t in enumerate(tail):
        yield t, "tail", i, None, params.tail[i]


def _layer_cache(caches, kind: str, i: int, r) -> dict:
    """One layer's cache (``{"k", "v"}``, ``{"conv", "h"}`` or ``{"conv",
    "state"}``): views into the stacked leaves (so in-place writes land in
    the tree)."""
    return {name: (leaf[r] if r is not None else leaf)
            for name, leaf in caches[kind][i].items()}


# ----------------------------------------------------------------------------
# caches
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, t_max: int, pool_pages: int = 0,
               page_size: int = 0, device=None) -> dict:
    """The batched decode-cache tree.  With ``pool_pages > 0`` every
    full-attention leaf is a shared physical page pool ``[pool_pages,
    page_size, Hkv, D]`` (stacked over the unit's repetitions) instead of a
    dense ``[batch, t_max]`` reservation.  Sliding-window layers keep a
    per-slot ring ``[batch, min(t_max, window)]`` either way, and ``R`` and
    ``M`` blocks their per-slot conv window and float32 state."""
    dev = resolve_device(device)
    dtype = cfg.param_dtype
    hd = cfg.resolved_head_dim
    unit, reps, tail = pattern_unit(cfg)

    def leaf(t, lead):
        if t in ("R", "M"):
            return {name: torch.zeros(lead + shape, dtype=dt, device=dev)
                    for name, (shape, dt) in _state_shapes(
                        t, cfg, batch, dtype).items()}
        if pool_pages and _full_attn(t, cfg):
            shape = (pool_pages, page_size, cfg.n_kv_heads, hd)
        else:
            length = (min(t_max, cfg.sliding_window)
                      if t == "L" and cfg.sliding_window else t_max)
            shape = (batch, length, cfg.n_kv_heads, hd)
        return {name: torch.zeros(lead + shape, dtype=dtype, device=dev)
                for name in ("k", "v")}

    return {"unit": [leaf(t, (reps,)) for t in (unit if reps > 0 else "")],
            "tail": [leaf(t, ()) for t in tail]}


def _state_shapes(t: str, cfg: ModelConfig, batch: int, dtype) -> dict:
    """``{name: (shape, dtype)}`` of an ``R`` or ``M`` block's per-slot
    decode state; the recurrent state is float32 whatever ``dtype``."""
    if t == "R":
        w = cfg.rglru.lru_width or cfg.d_model
        return {"conv": ((batch, cfg.rglru.conv_width - 1, w), dtype),
                "h": ((batch, w), torch.float32)}
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return {"conv": ((batch, s.conv_width - 1, d_in + 2 * s.d_state), dtype),
            "state": ((batch, d_in // s.head_dim, s.head_dim, s.d_state),
                      torch.float32)}


def paged_entries(cfg: ModelConfig):
    """The ``(kind, index)`` cache entries the paged pool backs: every
    full-attention layer's ``k``/``v``."""
    unit, reps, tail = pattern_unit(cfg)
    out = []
    for kind, types in (("unit", unit if reps > 0 else ""), ("tail", tail)):
        for i, t in enumerate(types):
            if _full_attn(t, cfg):
                out.append((kind, i))
    return out


def _full_attn(t: str, cfg: ModelConfig) -> bool:
    return t in ("A", "L") and not (t == "L" and cfg.sliding_window)


def _flat_frames(pool: torch.Tensor) -> torch.Tensor:
    """Pool leaf ``[lead..., n_pages, page_size, Hkv, D]`` → flattened frame
    axis ``[lead..., F, Hkv, D]``."""
    return pool.reshape(tuple(pool.shape[:-4]) + (-1,)
                        + tuple(pool.shape[-2:]))


# ----------------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------------

def _sliding_cache_update(cache_kv: torch.Tensor, k_new: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
    """Ring write for a sliding-window cache ``[B, W, Hkv, D]``: the new
    token's K/V lands at slot ``pos % W`` (``pos`` scalar or per row
    ``[B]``), in place."""
    return cm._cache_write(cache_kv, k_new, pos % cache_kv.shape[1])


def _ring_window(kv: torch.Tensor, length: int) -> torch.Tensor:
    """Prefill's ring install for a window shorter than the prompt: the last
    ``length`` positions of ``kv [B, S, Hkv, D]``, rolled so position ``p``
    sits at slot ``p % length`` (``torch.roll`` moves the way ``jnp.roll``
    does)."""
    s = kv.shape[1]
    return torch.roll(kv[:, s - length:], s % length, dims=1)


def _block_apply(t: str, bp: Block, x: torch.Tensor, cfg: ModelConfig, *,
                 positions, cache=None, pos=None, kv_chunk: int = 0,
                 pm_cache=None, final_state: bool = True):
    """One layer of type ``t``.  With ``pm_cache`` (scheduled decode)
    attention runs on the layer's port-major cache from the step's read
    burst and updates it in place; with ``cache`` (per-layer decode, and
    the ring, recurrent and SSM layers of the scheduled step) it writes the
    new token into the layer's line-major or ring cache in place and
    attends over it, or steps the recurrent state and writes it back in
    place; without either it runs over the current sequence (prefill) and
    returns the new line-major K/V, or the state the decode goes on from
    (the reference's ``_recover_rec_state``; not with ``final_state``
    False, as the training forward has no use for it)."""
    h = cm.apply_norm(x, bp.norm1, cfg.norm)
    if t in ("R", "M"):
        apply, state = ((rglru.rglru_apply, rglru.final_state) if t == "R"
                        else (mamba2.mamba_apply, mamba2.final_state))
        p = bp.rec if t == "R" else bp.mixer
        out, new_state = apply(p, h, cfg, cache)
        if cache is None:
            new_state = state(p, h, cfg) if final_state else None
        else:
            for name, leaf in new_state.items():
                cache[name].copy_(leaf)
        if t == "M":                      # a Mamba block: the mixer only
            return x + out, new_state
        h, new_kv = out, new_state
    elif pm_cache is not None:
        qpos = pos[None] if pos.ndim == 0 else pos[:, None]
        h, new_kv = cm.attention_apply_banked(
            bp.attn, h, cfg, positions=qpos, layer_kind=t,
            cache={"k_pm": pm_cache["k_pm"], "v_pm": pm_cache["v_pm"],
                   "pos": pos})
    elif cache is not None:
        h, new_kv = _attn_cached(bp.attn, h, cfg, t,
                                 {"k": cache["k"], "v": cache["v"],
                                  "pos": pos},
                                 ring=t == "L" and bool(cfg.sliding_window),
                                 kv_chunk=kv_chunk)
    else:
        h, new_kv = cm.attention_apply(bp.attn, h, cfg, positions=positions,
                                       layer_kind=t, kv_chunk=kv_chunk)
    x = x + h
    h = cm.apply_norm(x, bp.norm2, cfg.norm)
    if cfg.moe is not None:
        return x + moe.moe_apply(bp.ffn, h, cfg), new_kv
    return x + cm.mlp_apply(bp.ffn, h, cfg.mlp), new_kv


def _recompute_quietly():
    """``torch.utils.checkpoint``'s contexts: the forward as it is, the
    recompute inside the backward with no ambient MoE stats sink."""
    return contextlib.nullcontext(), moe.dispatch_stats(None)


def remat(cfg: ModelConfig, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, rematerialised in the backward when
    ``cfg.remat != "none"`` and grad is enabled: ``torch.utils.checkpoint.
    checkpoint(..., use_reentrant=False)``, value-identical to the plain
    call (``"dots"`` saves nothing either).  The recompute runs with no
    ambient :func:`repro_torch.models.moe.dispatch_stats` sink, so a
    training step's MoE movement is counted once, in its forward: the
    recomputed bursts launch their kernels again but add nothing to
    ``SchedulerStats`` or ``tokens_dropped``."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, context_fn=_recompute_quietly,
        **kwargs)


def _train_block(t: str, bp: Block, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, kv_chunk: int) -> torch.Tensor:
    return _block_apply(t, bp, x, cfg, positions=positions, kv_chunk=kv_chunk,
                        final_state=False)[0]


def forward(params: LM, tokens: torch.Tensor, cfg: ModelConfig, *,
            patch_embeds=None, kv_chunk: int = 0) -> torch.Tensor:
    """The training forward → logits ``[B, S(+P), V]`` (float32, over the
    padded vocab): no caches, every layer over the whole sequence, a VLM's
    ``patch_embeds [B, P, d]`` before the text.  Each block is
    rematerialised in the backward (:func:`remat`) unless ``cfg.remat`` is
    ``"none"``.  It never calls :func:`prefill`, whose caches are written
    in place."""
    x = cm.embed_apply(params.embed, tokens)
    if cfg.n_patches and patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    for t, _, _, _, block in _layers(params, cfg):
        x = remat(cfg, _train_block, t, block, x, cfg, positions, kv_chunk)
    x = cm.apply_norm(x, params.final_norm, cfg.norm)
    return cm.logits_apply(params.embed, x, cfg)


def _attn_cached(p, x: torch.Tensor, cfg: ModelConfig, layer_kind: str,
                 cache: dict, ring: bool, kv_chunk: int = 0):
    """Decode-path attention with a full or a ring (windowed) cache.

    Full: :func:`repro_torch.models.common.attention_apply`'s cached
    branch.  Ring: slot ``j`` holds absolute position ``pos - ((pos - j) %
    W)``; at a scalar position the ring goes through ``cached_attention``
    (port-major, the layout engine), at per-row positions through
    :func:`_ring_attention_per_row` (line-major).  RoPE uses
    ``cfg.rope_theta``, as the reference's ring branch does."""
    pos = cache["pos"]
    qpos = pos[None] if pos.ndim == 0 else pos[:, None]
    if not ring:
        return cm.attention_apply(p, x, cfg, positions=qpos,
                                  layer_kind=layer_kind, cache=cache,
                                  kv_chunk=kv_chunk)
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    win = cache["k"].shape[1]
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    q = cm.rope(q, qpos, cfg.rope_theta)
    k = cm.rope(k, qpos, cfg.rope_theta)
    ck = _sliding_cache_update(cache["k"], k, pos)
    cv = _sliding_cache_update(cache["v"], v, pos)
    slots = torch.arange(win, device=x.device)
    if pos.ndim == 0:
        slot_pos = pos - ((pos - slots) % win)   # absolute position per slot
        valid = (slot_pos >= 0) & (slot_pos <= pos)
        out = cm.cached_attention(q, ck, cv, pos, slot_pos, valid, 0, cfg)
    else:
        slot_pos = pos[:, None] - ((pos[:, None] - slots[None, :]) % win)
        valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
        out = _ring_attention_per_row(q, ck, cv, valid)
    y = out.reshape(b, s, h * hd) @ p["wo"]
    return y, {"k": ck, "v": cv}


def _ring_attention_per_row(q, ck, cv, valid):
    """Ring-cache decode attention with per-row slot positions (serving):
    ``q [B,1,H,D]`` against the line-major ring ``ck/cv [B,W,Hkv,D]``, the
    window already enforced by the ring's size, ``valid [B, W]``."""
    b, sq, h, d = q.shape
    hkv = ck.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d) * (d ** -0.5)
    s = torch.einsum("bqhgd,bthd->bhgqt", qg.to(ck.dtype), ck).float()
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.tensor(-1e30, dtype=torch.float32,
                                 device=s.device))
    p_attn = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqt,bthd->bqhgd", p_attn.to(cv.dtype), cv)
    return out.reshape(b, sq, h, d)


def _check_positions(pos, caches, cfg: ModelConfig, page_table,
                     t_depth: int) -> np.ndarray:
    """The decode positions on the host, checked against the cache depth.
    A position past the full-attention depth (``t_depth`` under the page
    pool, else the leaves' time axis) is refused: the reference's
    ``dynamic_update_slice`` would clamp it onto the last frame, and an
    index write here would fault.  Ring layers take any position."""
    host = np.asarray(pos.cpu() if isinstance(pos, torch.Tensor) else pos)
    if host.ndim > 1:
        raise ValueError(f"decode position must be a scalar or [B], got "
                         f"shape {host.shape}")
    depth = t_depth if page_table is not None else min(
        (caches[kind][i]["k"].shape[-3] for kind, i in paged_entries(cfg)),
        default=None)
    if (host < 0).any() or (depth is not None and (host >= depth).any()):
        raise ValueError(
            f"decode position {host.tolist()} is outside the KV cache depth "
            f"{depth}: size t_max for prompt + generated tokens")
    return host


def _emit_logits(params, x: torch.Tensor, cfg: ModelConfig,
                 draft: bool) -> torch.Tensor:
    """Step logits off the final-norm hidden state.  With ``draft`` (and
    draft heads in ``params``) the k Medusa draft heads' logits follow the
    real unembedding's along the position axis: ``[B, 1+k, V]``, row 0
    the very tensor the step returns without ``draft``."""
    logits = cm.logits_apply(params.embed, x, cfg)
    heads = getattr(params, "draft", None)
    if draft and heads is not None:
        logits = torch.cat(
            [logits, cm.draft_logits(heads, x, params.embed, cfg)], dim=1)
    return logits


def decode_step(params: LM, token, caches, pos, cfg: ModelConfig, sched=None,
                page_table=None, page_size: int = 0, t_depth: int = 0,
                live_plan=None, shard_plans=None, draft: bool = False):
    """One decode step: ``token [B, 1]`` + caches at ``pos`` (scalar, or per
    slot ``[B]``; a host value or a tensor) → ``(logits [B, 1, V],
    caches)``.  Positions outside the cache depth raise ``ValueError``.
    With ``draft`` the Medusa draft heads ride along on every path: the
    logits become ``[B, 1+k, V]``, row 0 unchanged (:func:`_emit_logits`).

    Without ``sched`` this is the per-layer path: every layer writes the
    new token's K/V into its line-major (or ring) cache and reads the cache
    through the fabric's KV layout engine — on the medusa fabric one
    layout-engine kernel launch per layer for its K and V leaves, none for
    a one-head cache (ring layers at per-row positions, and every layer on
    the ``fused`` fabric, attend line-major instead).

    With a ``BurstScheduler`` every full-attention leaf's port-major
    conversion is one shared read burst at the top of the step; attention
    runs (and writes the new token's K/V) in port-major space; one write
    burst restores line-major caches at the bottom; ring layers keep their
    own caches.  Under ``cfg.serve_fsdp`` the weights ride the same read
    burst and the step computes with what comes back.  With ``page_table``
    the leaves are shared page pools; with ``live_plan`` (the operands of
    :func:`repro_torch.models.common.page_live_plan`, as tensors) the pool
    gather is fused into the bursts (sparse-extent streams — the ``live``
    form), otherwise the burst banks the whole pool and the gather runs
    after it (the ``phys`` form).  On the fused form the write burst
    scatters into the pool leaves in place, so the returned caches share
    storage with ``caches``.

    With ``shard_plans`` (``{reps: (fetch, place)}``, the device operands
    of :func:`repro_torch.fabric.shard_plan`, one per distinct leaf rep
    count, for a fabric with ``pool_shards > 1``) the fused sparse bursts
    lower over the sharded pool instead: per-shard fused gathers and
    scatters bridged by one collective per stream
    (:mod:`repro_torch.fabric.sharded`), bit for bit the fused form.
    Requires ``live_plan``.

    A fabric off the port-per-KV-head geometry, or the ``fused`` fabric,
    cannot bank the leaves (:func:`_burst_plan` gives None): the step then
    takes the per-layer path, through the page pool with
    :func:`_decode_step_paged_fallback` when there is a ``page_table``."""
    host = _check_positions(pos, caches, cfg, page_table, t_depth)
    pos = torch.as_tensor(host, dtype=torch.int32, device=token.device)
    positions = pos[None] if pos.ndim == 0 else pos[:, None]
    phys = (None if page_table is None
            else cm.page_gather_indices(page_table, page_size, t_depth))
    plan = _burst_plan(cfg, caches) if sched is not None else None
    if plan is not None:
        live = live_plan if phys is not None else None
        return _decode_step_scheduled(params, token, caches, pos, positions,
                                      cfg, sched, plan, phys=phys, live=live,
                                      shard_plans=(shard_plans
                                                   if live is not None
                                                   else None), draft=draft)
    if phys is not None:
        return _decode_step_paged_fallback(params, token, caches, pos,
                                           positions, cfg, phys, draft=draft)
    return _decode_step_layers(params, token, caches, pos, positions, cfg,
                               draft=draft)


def _decode_step_layers(params: LM, token, caches, pos, positions,
                        cfg: ModelConfig, draft: bool = False):
    """The per-layer decode step (see :func:`decode_step`)."""
    x = cm.embed_apply(params.embed, token)
    for t, kind, i, r, block in _layers(params, cfg):
        x, _ = _block_apply(t, block, x, cfg, positions=positions,
                            cache=_layer_cache(caches, kind, i, r), pos=pos)
    x = cm.apply_norm(x, params.final_norm, cfg.norm)
    return _emit_logits(params, x, cfg, draft), caches


def _decode_step_paged_fallback(params: LM, token, caches, pos, positions,
                                cfg: ModelConfig, phys, draft: bool = False):
    """The per-layer paged decode (no scheduler, an off-geometry fabric, or
    the ``fused`` fabric): gather each pool leaf into its dense line-major
    view ``[lead..., B, T, Hkv, D]`` through ``phys``, run the per-layer
    path on those views, and scatter the updated frames back into the pool
    leaves in place.  Ring leaves are the caller's and update in place."""
    entries = paged_entries(cfg)
    dense = {"unit": list(caches["unit"]), "tail": list(caches["tail"])}
    for kind, i in entries:
        dense[kind][i] = {}
        for name, pool in caches[kind][i].items():
            flat = _flat_frames(pool)
            dense[kind][i][name] = cm.gather_pool_frames(flat, phys,
                                                         flat.ndim - 3)
    logits, _ = _decode_step_layers(params, token, dense, pos, positions,
                                    cfg, draft=draft)
    for kind, i in entries:
        for name, pool in caches[kind][i].items():
            cm.scatter_pool_frames(_flat_frames(pool), dense[kind][i][name],
                                   phys, pool.ndim - 4)
    return logits, caches


def _burst_plan(cfg: ModelConfig, caches):
    """The cache entries the scheduled step routes through the shared
    burst, or None when the fabric is off the port-per-KV-head geometry or
    is ``fused`` (which never banks: its consumers contract the line-major
    cache, so banking would make the very copies it elides)."""
    fab = cfg.resolved_fabric
    n = fab.n_ports
    if fab.impl == "fused":
        return None
    if n != cfg.n_kv_heads or fab.lane_width != cfg.resolved_head_dim:
        return None
    unit, reps, tail = pattern_unit(cfg)
    plan = []
    for kind, types in (("unit", unit if reps > 0 else ""), ("tail", tail)):
        for i, t in enumerate(types):
            if not _full_attn(t, cfg):
                continue
            leaf = caches[kind][i]["k"]
            lines = math.prod(leaf.shape[:-2])
            if leaf.shape[-2] != n or lines % n:
                return None
            plan.append((kind, i))
    return plan or None


def _decode_step_scheduled(params: LM, token, caches, pos, positions,
                           cfg: ModelConfig, sched, plan, phys=None,
                           live=None, shard_plans=None, draft: bool = False):
    """The burst-scheduled decode step (see :func:`decode_step`)."""
    if live is not None:
        live_idx, expand, dense_pos = live

    def leaf_reps(leaf):
        """The leaf's leading layer-stack factor (1 for tail leaves)."""
        return math.prod(_flat_frames(leaf).shape[:-3])

    def leaf_gather_idx(leaf):
        """The step's live frames tiled over the leaf's leading layer axis."""
        flat = _flat_frames(leaf)
        if flat.ndim == 3:                       # tail leaf: [F, N, D]
            return live_idx
        return cm.pool_rep_indices(live_idx, leaf_reps(leaf), flat.shape[-3])

    def leaf_shard(leaf):
        """The leaf's ``shard=`` operands: the step's fetch/place plan for
        its rep count, and its line total."""
        reps = leaf_reps(leaf)
        fetch, place = shard_plans[reps]
        return fetch, place, reps * live_idx.shape[0]

    def leaf_stream(leaf):
        """The leaf's rep-major pool line stream ``[R, F, N, D]``, a view
        of the leaf (the explicit rep axis keeps page ownership the same in
        every rep)."""
        flat = _flat_frames(leaf)
        if flat.ndim == 3:
            return flat[None]
        return flat.reshape((-1,) + tuple(flat.shape[-3:]))

    # -- burst 1: weight stream + KV banking ----------------------------------
    streamed = (_enqueue_weight_stream(sched, params,
                                       cfg.resolved_fabric.n_ports)
                if cfg.serve_fsdp else None)
    for kind, i in plan:
        for leaf_name in ("k", "v"):
            leaf = caches[kind][i][leaf_name]
            if phys is not None and shard_plans is not None:
                sched.enqueue_read(f"{kind}{i}/{leaf_name}",
                                   leaf_stream(leaf), shard=leaf_shard(leaf))
                continue
            if phys is not None:
                sched.enqueue_read(
                    f"{kind}{i}/{leaf_name}",
                    cm.kv_leaf_to_lines(_flat_frames(leaf)),
                    gather=leaf_gather_idx(leaf) if live is not None
                    else None)
                continue
            sched.enqueue_read(f"{kind}{i}/{leaf_name}",
                               cm.kv_leaf_to_lines(leaf))
    sched.issue()
    moved = sched.commit()
    if streamed is not None:
        params = _rebuild_weight_stream(params, moved, streamed)

    pm = {"unit": [None] * len(caches["unit"]),
          "tail": [None] * len(caches["tail"])}
    pm_pools = {}
    for kind, i in plan:
        if phys is None:
            lead = caches[kind][i]["k"].shape[:-2]
            pm[kind][i] = {
                leaf_name + "_pm": cm.banked_to_port_major(
                    moved[f"{kind}{i}/{leaf_name}"], lead)
                for leaf_name in ("k", "v")}
            continue
        flat_shape = _flat_frames(caches[kind][i]["k"]).shape
        if live is not None:
            lead = tuple(flat_shape[:-3]) + (live_idx.shape[0],)
        else:
            lead = tuple(flat_shape[:-2])
        entry = {}
        for leaf_name in ("k", "v"):
            # [lead?, Hkv, F|L_live, D]: each port's frame stream
            pool_pm = cm.banked_to_port_major(
                moved[f"{kind}{i}/{leaf_name}"], lead)
            if live is None:
                pm_pools[(kind, i, leaf_name)] = pool_pm
            # fused: expand relabels the compact live frames to the dense
            # [B, T] view; fallback: the full logical→physical gather
            dense_pm = cm.gather_pool_frames(
                pool_pm, expand if live is not None else phys,
                pool_pm.ndim - 2)
            # [lead?, Hkv, B, T, D] → [lead?, B, Hkv, T, D]
            entry[leaf_name + "_pm"] = dense_pm.movedim(-3, -4)
        pm[kind][i] = entry

    x = cm.embed_apply(params.embed, token)
    for t, kind, i, r, block in _layers(params, cfg):
        entry = pm[kind][i]
        if entry is None:                 # a ring layer: its own cache
            x, _ = _block_apply(t, block, x, cfg, positions=positions,
                                cache=_layer_cache(caches, kind, i, r),
                                pos=pos)
            continue
        layer_pm = ({name: leaf[r] for name, leaf in entry.items()}
                    if r is not None else entry)
        x, _ = _block_apply(t, block, x, cfg, positions=positions, pos=pos,
                            pm_cache=layer_pm)

    # -- burst 2: updated port-major caches → line-major --------------------
    for kind, i in plan:
        for leaf_name in ("k", "v"):
            new_pm = pm[kind][i][leaf_name + "_pm"]
            leaf = caches[kind][i][leaf_name]
            if phys is not None and live is not None:
                # compact the updated dense view back to live frames and
                # scatter them into the pool through the sparse write burst
                upd = new_pm.movedim(-4, -3)           # [lead?, Hkv, B, T, D]
                flat = upd.reshape(tuple(upd.shape[:-3])
                                   + (upd.shape[-3] * upd.shape[-2],)
                                   + tuple(upd.shape[-1:]))
                compact = cm.gather_pool_frames(flat, dense_pos,
                                                flat.ndim - 2)
                if shard_plans is not None:
                    sched.enqueue_write(
                        f"{kind}{i}/{leaf_name}",
                        cm.port_major_to_banked(compact),
                        shard=leaf_shard(leaf), into=leaf_stream(leaf))
                    continue
                sched.enqueue_write(
                    f"{kind}{i}/{leaf_name}",
                    cm.port_major_to_banked(compact),
                    scatter=leaf_gather_idx(leaf),
                    into=cm.kv_leaf_to_lines(_flat_frames(leaf)))
                continue
            if phys is not None:
                # scatter the updated per-slot frames back into the
                # port-major pool before it returns through the write burst
                pool_pm = pm_pools[(kind, i, leaf_name)]
                new_pm = cm.scatter_pool_frames(
                    pool_pm, new_pm.movedim(-4, -3), phys, pool_pm.ndim - 2)
            sched.enqueue_write(f"{kind}{i}/{leaf_name}",
                                cm.port_major_to_banked(new_pm))
    sched.issue()
    lines_back = sched.commit()
    new_caches = {"unit": list(caches["unit"]), "tail": list(caches["tail"])}
    for kind, i in plan:
        shape = caches[kind][i]["k"].shape
        new_caches[kind][i] = {
            leaf_name: lines_back[f"{kind}{i}/{leaf_name}"].reshape(shape)
            for leaf_name in ("k", "v")}

    x = cm.apply_norm(x, params.final_norm, cfg.norm)
    return _emit_logits(params, x, cfg, draft), new_caches


def _weight_slots(params):
    """The reference's parameter leaves in its ``tree_flatten`` order (dict
    keys sorted: ``draft`` when there are draft heads, ``embed``,
    ``final_norm``, ``tail``, ``unit``; lists in order), each as its
    ``(dict, name)`` slots in ``params`` (an :class:`LM`, or the step's
    copy of one): one slot per repetition for a ``unit`` leaf, which the
    reference stacks into one leaf, else one.  A MoE block's ``ffn``
    leaves come as ``router``, ``w_gate``, ``w_out``, ``w_up``; the
    float32 router of a bf16 model streams in its own dtype group."""
    heads = getattr(params, "draft", None)
    if heads is not None:
        yield [(heads, "w")]
    for group in ("embed", "final_norm"):
        pdict = getattr(params, group)
        for name in sorted(pdict.keys()):
            yield [(pdict, name)]
    for block in params.tail:
        for part in _block_parts(block):
            pdict = getattr(block, part)
            for name in sorted(pdict.keys()):
                yield [(pdict, name)]
    for blocks in params.unit:
        for part in _block_parts(blocks[0]):
            for name in sorted(getattr(blocks[0], part).keys()):
                yield [(getattr(b, part), name) for b in blocks]


def _enqueue_weight_stream(sched, params: LM, n: int):
    """``serve_fsdp`` weight streaming: queue every weight leaf whose size
    divides N² as a single-group line stream ``[N, N, size/N²]`` in the
    step's read burst, named ``weight_stream/<j>`` for the leaf's index
    ``j`` in the reference's tree order — the same groups of bytes the
    reference streams (a ``unit`` leaf's repetitions are stacked into one
    stream each step).  Other leaves stay resident.  Returns the streamed
    ``j``."""
    streamed = []
    for j, slots in enumerate(_weight_slots(params)):
        tensors = [pdict[name] for pdict, name in slots]
        size = sum(t.numel() for t in tensors)
        if size and size % (n * n) == 0:
            leaf = tensors[0] if len(tensors) == 1 else torch.stack(tensors)
            sched.enqueue_read(f"weight_stream/{j}", leaf.reshape(n, n, -1))
            streamed.append(j)
    return streamed


def _rebuild_weight_stream(params: LM, moved, streamed):
    """The decode step's weights after the stream: each streamed leaf is
    its port's bank read back (``banked[0]`` transposed, an exact round
    trip) and replaces the resident tensors, a stacked leaf split back
    into its repetitions; the rest stay resident.  Returns a copy of
    ``params``' structure that the decode path reads as an :class:`LM`."""
    def copy(block):
        return types.SimpleNamespace(**{part: dict(getattr(block, part))
                                        for part in _block_parts(block)})
    heads = getattr(params, "draft", None)
    out = types.SimpleNamespace(
        draft=None if heads is None else dict(heads),
        embed=dict(params.embed), final_norm=dict(params.final_norm),
        unit=[[copy(b) for b in blocks] for blocks in params.unit],
        tail=[copy(b) for b in params.tail])
    slots = list(_weight_slots(out))
    for j in streamed:
        pdict, name = slots[j][0]
        banked = moved[f"weight_stream/{j}"]             # [1, N, N, W]
        leaf = banked[0].transpose(0, 1).reshape(
            (len(slots[j]),) + tuple(pdict[name].shape))
        for (pdict, name), rep in zip(slots[j], leaf):
            pdict[name] = rep
    return out


def prefill(params: LM, tokens: torch.Tensor, cfg: ModelConfig, t_max: int,
            patch_embeds=None, kv_chunk: int = 0):
    """Prefill: the forward pass that also installs line-major KV caches
    ``[reps, B, t_max, Hkv, D]``; a ring shorter than the prompt takes its
    last ``W`` positions, rolled so position ``p`` sits at slot ``p % W``;
    an ``R`` or ``M`` block installs its conv window and final state.  A
    VLM config (``cfg.n_patches``) given ``patch_embeds [B, P, d]`` puts
    them before the text's embeddings, in the model dtype; positions run
    over both.  Returns ``(logits [B, 1, V], caches)`` with the logits of
    the last position."""
    b = tokens.shape[0]
    caches = init_cache(cfg, b, t_max, device=tokens.device)
    x = cm.embed_apply(params.embed, tokens)
    if cfg.n_patches and patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    s = x.shape[1]
    positions = torch.arange(s, device=tokens.device)
    for t, kind, i, r, block in _layers(params, cfg):
        x, kv = _block_apply(t, block, x, cfg, positions=positions,
                             kv_chunk=kv_chunk)
        for name, leaf in _layer_cache(caches, kind, i, r).items():
            if t in ("R", "M"):
                leaf.copy_(kv[name])
                continue
            length = leaf.shape[1]
            if length >= s:
                leaf[:, :s] = kv[name]
            else:
                leaf.copy_(_ring_window(kv[name], length))
    x = cm.apply_norm(x, params.final_norm, cfg.norm)
    return cm.logits_apply(params.embed, x[:, -1:], cfg), caches
