"""Shared model components (port of the parts of ``repro.models.common``
the dense decoder runs): norms, RoPE, attention for prefill, for the
per-layer cached decode (through the fabric's KV layout engine, or
line-major on the ``fused`` fabric) and for port-major decode, the KV
banking relabels, the page-pool plan helpers, the MLP, embeddings,
sinusoidal positions (whisper), logits, the Medusa draft heads and the
training loss.

The numerics follow the reference op for op, so the two packages compare
within float32 rounding: layer norm in float32 with eps 1e-5, RoPE
frequencies in float32, prefill scores in float32, decode scores dotted in
the cache dtype and upcast afterwards, logits accumulated in float32 over
the padded vocab.  Matrix products stay ``torch`` ops (the reference left
them to XLA too); no fused attention operator is used.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.fabric.fabric import (Fabric, _put_drop, _take_fill,
                                       pm_to_banked)
from repro_torch.fabric.scheduler import FRAME_SENTINEL as _SENTINEL


def pad_vocab(v: int, multiple: int = 128) -> int:
    return -(-v // multiple) * multiple


def trunc_normal(generator: torch.Generator, shape, device,
                 scale: float) -> torch.Tensor:
    """A float32 draw from the standard normal truncated to [-2, 2], times
    ``scale`` (the reference's ``trunc_normal``, from a torch generator)."""
    draw = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    return draw * scale


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def apply_norm(x: torch.Tensor, p, kind: str) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


# ----------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding on ``x [..., S, H, D]`` with ``positions [..., S]``."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None] * freq                  # [..., S, half]
    ang = ang[..., None, :]                                    # [..., S, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """The sinusoidal absolute position embedding ``[seq, d]`` in float32
    (whisper): ``sin`` over the first half of the channels, ``cos`` over
    the second."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10_000.0, 2.0 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """:func:`sinusoidal_positions`' row for one position ``pos`` (a
    scalar tensor) → ``[d]``."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos.float() / torch.pow(10_000.0, 2.0 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)])


# ----------------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------------

def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B,Sq,Hkv,G,D] x k [B,Sk,Hkv,D] → float32 [B,Hkv,G,Sq,Sk]."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())


def _mask_scores(scores, q_pos, k_pos, causal: bool, window: int):
    """Causal / sliding-window masking in position space."""
    qp = q_pos[..., :, None] if q_pos.ndim == 1 \
        else q_pos[:, None, None, :, None]
    kp = k_pos[..., None, :] if k_pos.ndim == 1 \
        else k_pos[:, None, None, None, :]
    neg = torch.tensor(-1e30, dtype=torch.float32, device=scores.device)
    if causal:
        scores = torch.where(qp >= kp, scores, neg)
    if window:
        scores = torch.where(qp - kp < window, scores, neg)
    return scores


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_positions: torch.Tensor, kv_positions: torch.Tensor,
              causal: bool = True, window: int = 0,
              kv_chunk: int = 0) -> torch.Tensor:
    """Grouped-query attention, ``q [B, Sq, H, D]``, ``k/v [B, Sk, Hkv,
    D]``.  With ``kv_chunk > 0`` the KV axis runs in chunks with an online
    softmax (the long-prompt form)."""
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d) * (d ** -0.5)

    if not kv_chunk or kv_chunk >= sk:
        scores = _gqa_scores(qg, k)
        scores = _mask_scores(scores, q_positions, kv_positions, causal,
                              window)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
        return out.reshape(b, sq, h, d)

    n_chunks = sk // kv_chunk
    k_c = k.reshape(b, n_chunks, kv_chunk, hkv, d)
    v_c = v.reshape(b, n_chunks, kv_chunk, hkv, d)
    kp_c = kv_positions.reshape(n_chunks, kv_chunk)
    m = torch.full((b, hkv, g, sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=v.dtype, device=q.device)
    for c in range(n_chunks):
        s = _mask_scores(_gqa_scores(qg, k_c[:, c]), q_positions, kp_c[c],
                         causal, window)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype), v_c[:, c])
        acc = acc * alpha[..., None].to(acc.dtype) + pv
        m = m_cur
    out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
    return out.movedim(-2, 1).reshape(b, sq, h, d)


def _qkv_project(p, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                 layer_kind: str, apply_rope: bool = True):
    """Attention prologue: QKV projection and RoPE with the layer-kind
    theta.  Returns ``(q, k, v, window)``."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    theta = cfg.rope_theta
    if layer_kind == "A" and cfg.rope_theta_global:
        theta = cfg.rope_theta_global
    window = cfg.sliding_window if layer_kind == "L" else 0
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    if apply_rope:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    return q, k, v, window


def _attn_output(p, out: torch.Tensor) -> torch.Tensor:
    b, s = out.shape[:2]
    return out.reshape(b, s, -1) @ p["wo"]


def attention_apply(p, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                    layer_kind: str, cache=None, kv_chunk: int = 0,
                    apply_rope: bool = True, causal: bool = True):
    """Self-attention with an optional KV cache.

    Training/prefill (``cache`` None): keys from the current sequence;
    returns ``(out, {"k", "v"})``, the line-major KV for cache install.
    Decode: ``cache = {"k"/"v": [B, T, Hkv, D] line-major, "pos": scalar or
    [B]}``; the new token's K/V is written at ``pos`` **in place** (the
    cache tensors are updated, not copied) and the cache is read through
    the fabric's KV layout engine (:func:`cached_attention`).  Returns
    ``(out, {"k", "v", "pos"})``."""
    q, k, v, window = _qkv_project(p, x, cfg, positions=positions,
                                   layer_kind=layer_kind,
                                   apply_rope=apply_rope)
    if cache is None:
        out = attention(q, k, v, positions, positions, causal=causal,
                        window=window, kv_chunk=kv_chunk)
        return _attn_output(p, out), {"k": k, "v": v}
    pos = cache["pos"]
    ck = _cache_write(cache["k"], k, pos)
    cv = _cache_write(cache["v"], v, pos)
    kv_pos = torch.arange(ck.shape[1], device=x.device)
    valid = (kv_pos <= pos if pos.ndim == 0
             else kv_pos[None, :] <= pos[:, None])
    out = cached_attention(q, ck, cv, pos, kv_pos, valid, window, cfg)
    return _attn_output(p, out), {"k": ck, "v": cv, "pos": pos}


def _cache_write(cache: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """Write the new token's K/V ``new [B, 1, Hkv, D]`` at ``pos`` (scalar,
    or per row ``[B]``) of ``cache [B, T, Hkv, D]``, in place.  The
    reference's ``dynamic_update_slice`` clamps an out-of-range start; the
    decode entry point rejects such a position on the host instead."""
    if pos.ndim == 0:
        cache[:, pos.long()] = new[:, 0]
    else:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, pos.long()] = new[:, 0]
    return cache


@functools.lru_cache(maxsize=64)
def _model_fabric(cfg) -> Fabric:
    """The model's fabric, built once per config (every K/V leaf of every
    decode step asks for it)."""
    return Fabric.for_model(cfg)


def _kv_port_major(c, cfg):
    """``[B, T, Hkv, D]`` line-major → ``[B, Hkv, T, D]`` port-major through
    the model's fabric (the layout-engine kernel on the medusa fabric):
    one leaf, or a sequence of leaves in one launch (→ a list)."""
    return _model_fabric(cfg).kv_port_major(c)


def cached_attention(q, ck, cv, pos, kv_pos, valid, window, cfg):
    """Decode attention over a line-major cache, by the model's fabric:
    ``medusa``/``crossbar``/``oracle`` re-bank K and V to port-major head
    streams first (one layout-engine launch for the pair on the medusa
    fabric, none for a one-head cache, whose port-major leaves are views
    of ``ck``/``cv``: they are read here, before anything writes the cache
    again); ``fused`` contracts the line-major cache directly
    (:func:`_decode_attention_linemajor`, no banked copy).  All fabrics are
    value-identical."""
    fabric = _model_fabric(cfg)
    if fabric.impl == "fused":
        return _decode_attention_linemajor(q, ck, cv, pos, kv_pos, valid,
                                           window)
    k_pm, v_pm = fabric.kv_port_major((ck, cv))
    return _decode_attention(q, k_pm, v_pm, pos, kv_pos, valid, window)


def _decode_attention_linemajor(q, k, v, pos, kv_pos, valid, window):
    """Decode attention of the ``fused`` fabric: ``q [B,1,H,D]`` against
    the line-major ``k/v [B,T,Hkv,D]``.  The cache-side dots run in the
    cache dtype; only the score tensor is upcast for the softmax."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d) * (d ** -0.5)
    s = torch.einsum("bqhgd,bthd->bhgqt", qg.to(k.dtype), k).float()
    s = torch.where(_expand_mask(_window_mask(valid, pos, kv_pos, window)),
                    s, torch.tensor(-1e30, dtype=torch.float32,
                                    device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqt,bthd->bqhgd", p.to(v.dtype), v)
    return out.reshape(b, sq, h, d)


# ----------------------------------------------------------------------------
# burst-scheduled KV banking (serving decode)
# ----------------------------------------------------------------------------

def kv_leaf_to_lines(leaf: torch.Tensor) -> torch.Tensor:
    """Line-major KV leaf ``[..., T, Hkv, D]`` → line stream ``[L, N, D]``."""
    return leaf.reshape((-1,) + tuple(leaf.shape[-2:]))


def banked_to_port_major(banked: torch.Tensor, lead_shape) -> torch.Tensor:
    """Read-network output ``[G, N, N, D]`` → port-major ``[..., Hkv, T,
    D]`` where ``lead_shape`` is the leaf's shape without ``(Hkv, D)``."""
    g, n, _, d = banked.shape
    pm = banked.permute(1, 0, 2, 3).reshape((n,) + tuple(lead_shape) + (d,))
    return pm.movedim(0, len(lead_shape) - 1)


def port_major_to_banked(pm: torch.Tensor) -> torch.Tensor:
    """Port-major ``[..., Hkv, T, D]`` → write-network input
    ``[G, N, N, D]`` (inverse of :func:`banked_to_port_major`)."""
    x = pm.movedim(pm.ndim - 3, 0)                # [Hkv, ..., T, D]
    n, d = x.shape[0], x.shape[-1]
    return pm_to_banked(x.reshape(n, -1, d), n)


# ----------------------------------------------------------------------------
# shared physical page pool: the decode step's plan helpers
# ----------------------------------------------------------------------------

def page_gather_indices(page_table: torch.Tensor, page_size: int,
                        t_depth: int) -> torch.Tensor:
    """Per-slot page table ``[B, pages_per_slot]`` (``-1`` = unmapped) →
    physical frame indices ``[B, t_depth]``; unmapped positions get the
    sentinel."""
    t = torch.arange(t_depth, dtype=torch.int32, device=page_table.device)
    pt = page_table[:, (t // page_size).long()]
    return torch.where(pt < 0, torch.full_like(pt, _SENTINEL),
                       pt * page_size + t % page_size)


def page_live_plan(page_table, page_size: int, t_depth: int, n_ports: int,
                   bucket: int = 0):
    """Host-side plan of a step's live frames for the fused-gather decode
    (numpy, as in the reference).  Returns ``int32`` arrays ``live_idx
    [L_pad]`` (each live frame's physical index, slot-major, sentinel-padded
    to a multiple of ``n_ports`` then ``bucket``), ``expand [S, t_depth]``
    (each dense position's index into the live list) and ``dense_pos
    [L_pad]`` (each live frame's flattened dense position)."""
    table = np.asarray(page_table)
    s_count = table.shape[0]
    mapped = (table >= 0).sum(axis=1)
    if not np.array_equal(table >= 0,
                          np.arange(table.shape[1])[None, :] < mapped[:, None]):
        raise ValueError("page table rows must map a logical-page prefix "
                         "(-1 entries only after the mapped pages)")
    live = np.minimum(mapped * page_size, t_depth)
    unit = max(n_ports, 1)
    l_pad = -(-max(int(live.sum()), 1) // unit) * unit
    if bucket:
        l_pad = -(-l_pad // bucket) * bucket
    live_idx = np.full((l_pad,), _SENTINEL, np.int32)
    expand = np.full((s_count, t_depth), _SENTINEL, np.int32)
    dense_pos = np.full((l_pad,), _SENTINEL, np.int32)
    off = 0
    for s in range(s_count):
        m = int(live[s])
        if not m:
            continue
        t = np.arange(m)
        live_idx[off:off + m] = (table[s, t // page_size] * page_size
                                 + t % page_size)
        expand[s, :m] = off + t
        dense_pos[off:off + m] = s * t_depth + t
        off += m
    return live_idx, expand, dense_pos


def pool_rep_indices(idx: torch.Tensor, reps: int,
                     frames: int) -> torch.Tensor:
    """Tile per-pool frame indices ``idx [K]`` over a leaf's leading layer
    axis: rep ``r`` occupies lines ``[r*frames, (r+1)*frames)``, valid
    entries shift by ``r*frames`` and sentinels stay sentinels."""
    offs = torch.arange(reps, dtype=torch.int32,
                        device=idx.device)[:, None] * frames
    tiled = idx[None, :].expand(reps, idx.shape[0])
    return torch.where(tiled < frames, tiled + offs,
                       torch.full_like(tiled, _SENTINEL)).reshape(-1)


def gather_pool_frames(pool_flat: torch.Tensor, phys: torch.Tensor,
                       axis: int) -> torch.Tensor:
    """Gather frames from a flattened frame axis at ``axis``: ``phys`` (any
    shape; sentinels read zeros) replaces that axis in the result."""
    return _take_fill(pool_flat, phys, axis)


def scatter_pool_frames(pool_flat: torch.Tensor, dense: torch.Tensor,
                        phys: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of :func:`gather_pool_frames`, in place: write the per-slot
    dense frames (``[B, T]`` at ``axis``) to their mapped physical frames;
    unmapped positions drop.  Mapped frames belong to one slot only."""
    upd = dense.reshape(tuple(dense.shape[:axis]) + (-1,)
                        + tuple(dense.shape[axis + 2:]))
    _put_drop(pool_flat, phys, upd, axis)
    return pool_flat


def _pm_cache_write(cache_pm: torch.Tensor, new: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """Write the new token's K/V at ``pos`` in port-major space, in place
    (``cache_pm [B, Hkv, T, D]``, ``new [B, 1, Hkv, D]``; pos scalar or
    [B]).  The port-major cache is the step's own copy (the read burst's
    output), so updating it in place is safe."""
    if pos.ndim == 0:
        cache_pm[:, :, pos] = new[:, 0]
    else:
        rows = torch.arange(cache_pm.shape[0], device=cache_pm.device)
        cache_pm[rows, :, pos.long()] = new[:, 0]
    return cache_pm


def _expand_mask(mask: torch.Tensor) -> torch.Tensor:
    """[T] or [B, T] decode mask → broadcastable over [B,hkv,g,1,T]."""
    if mask.ndim == 1:
        return mask[None, None, None, None, :]
    return mask[:, None, None, None, :]


def _window_mask(valid, pos, kv_pos, window):
    """The decode mask: ``valid`` and, for a windowed layer, keys within
    ``window`` positions of ``pos`` (scalar or ``[B]``)."""
    if not window:
        return valid
    dist = (pos - kv_pos if pos.ndim == 0
            else pos[:, None] - kv_pos[None, :])
    return valid & (dist < window)


def _decode_attention(q, k_pm, v_pm, pos, kv_pos, valid, window):
    """Single-step decode attention over a port-major cache: ``q
    [B,1,H,D]``, ``k_pm/v_pm [B,Hkv,T,D]``.  The cache-side dots run in the
    cache dtype; only the score tensor is upcast for the softmax."""
    b, sq, h, d = q.shape
    hkv = k_pm.shape[1]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d) * (d ** -0.5)
    s = torch.einsum("bqhgd,bhkd->bhgqk", qg.to(k_pm.dtype), k_pm).float()
    s = torch.where(_expand_mask(_window_mask(valid, pos, kv_pos, window)),
                    s, torch.tensor(-1e30, dtype=torch.float32,
                                    device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bqhgd", p.to(v_pm.dtype), v_pm)
    return out.reshape(b, sq, h, d)


def attention_apply_banked(p, x: torch.Tensor, cfg, *,
                           positions: torch.Tensor, layer_kind: str,
                           cache: dict):
    """Decode self-attention against a pre-banked port-major KV cache
    (``cache = {"k_pm"/"v_pm": [B, Hkv, T, D], "pos": [B]}``, the read
    burst's output for this layer).  The new token's K/V is written at
    ``pos`` in port-major space, in place, and attention runs on the
    updated cache.  Returns ``(out, {"k_pm", "v_pm"})``."""
    q, k, v, window = _qkv_project(p, x, cfg, positions=positions,
                                   layer_kind=layer_kind)
    pos = cache["pos"]
    ck_p = _pm_cache_write(cache["k_pm"], k, pos)
    cv_p = _pm_cache_write(cache["v_pm"], v, pos)
    t = ck_p.shape[2]
    kv_pos = torch.arange(t, device=x.device)
    valid = (kv_pos <= pos if pos.ndim == 0
             else kv_pos[None, :] <= pos[:, None])
    out = _decode_attention(q, ck_p, cv_p, pos, kv_pos, valid, window)
    return _attn_output(p, out), {"k_pm": ck_p, "v_pm": cv_p}


# ----------------------------------------------------------------------------
# MLP, embeddings, logits
# ----------------------------------------------------------------------------

def mlp_apply(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif kind == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_out"]


def embed_apply(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def logits_apply(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Logits over the padded vocab, accumulated in float32."""
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x.float(), p["table"].float())
    return torch.einsum("bsd,dv->bsv", x.float(), p["head"].float())


def draft_head_params(gen: torch.Generator, cfg, dtype, device) -> dict:
    """Medusa-style draft heads: ``cfg.spec_heads`` residual projections
    ``d_model → d_model`` (SiLU) off the final-norm hidden state, ``{"w":
    [k, d, d]}``, drawn from ``gen`` as :func:`repro_torch.models.lm.
    init_params` draws a projection (truncated normal over ``1/sqrt(d)``).
    Their logits come from the shared unembedding, so a head adds ``d²``
    parameters, not ``d·V``.  The numbers are not the reference's."""
    d = cfg.d_model
    return {"w": trunc_normal(gen, (cfg.spec_heads, d, d), device,
                              1.0 / math.sqrt(d)).to(dtype)}


def draft_logits(p_draft, x: torch.Tensor, p_embed, cfg) -> torch.Tensor:
    """``x [B, S, d]`` (final-norm hidden state) → ``[B, k, V]`` draft-head
    logits off the last position: head ``i`` proposes the token ``i+1``
    steps ahead of the one the real unembedding scores."""
    last = x[:, -1]                                         # [B, d]
    h = last[:, None, :] + F.silu(
        torch.einsum("bd,kde->bke", last, p_draft["w"]))   # [B, k, d]
    return logits_apply(p_embed, h, cfg)


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """Mean cross-entropy of ``logits [..., V]`` against ``targets [...]``;
    the padded vocabulary entries (``>= vocab_size``) are masked to -1e30
    before the logsumexp."""
    v = logits.shape[-1]
    if v > vocab_size:
        pad = torch.arange(v, device=logits.device) >= vocab_size
        logits = torch.where(pad, -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(lse - gold)
