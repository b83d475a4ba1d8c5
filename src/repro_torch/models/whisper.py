"""Whisper-style encoder-decoder (port of ``repro.models.whisper``;
arXiv:2212.04356) on the shared substrate.

The conv frontend is a stub, as in the reference: the batch supplies
precomputed frame embeddings ``frames [B, encoder_seq, d_model]``.
Positions are sinusoidal, attention is not rotary, norms follow
``cfg.norm`` (layer norm for whisper).

Parameters are a :class:`Whisper` module whose ``encoder`` and ``decoder``
hold the reference's stacked leaves (``[layers, ...]``, one
``ParameterDict`` per block part: ``norm1``, ``attn``, ``norm2``, ``ffn``,
and the decoder's ``norm_x`` and ``xattn``), so the tree, its key strings
and its leaf order are the reference's.  Each pass unbinds the stacks into
per-layer views once.

The decoder's cross-attention K/V are computed once from the encoder
output and made port-major through the model's fabric (``cm.
_kv_port_major``: the layout-engine kernel on the medusa fabric, one
launch for every decoder layer's K and V); decode keeps line-major
self-attention caches read through the same layout engine (one launch per
layer per step, for its K and V) and the static port-major cross K/V.  The decode step writes the new token's
K/V into the caches in place, as :mod:`repro_torch.models.lm` does.
"""

from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models.lm import _norm, _params, remat


def _block_shapes(cfg: ModelConfig, cross: bool) -> dict:
    """``{part: {name: shape}}`` of one encoder (or, with ``cross``,
    decoder) block, unstacked."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
            "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    norm = {"scale": (d,)} if cfg.norm == "rms" else {"scale": (d,),
                                                      "bias": (d,)}
    ffn = {"w_up": (d, cfg.d_ff), "w_out": (cfg.d_ff, d)}
    if cfg.mlp in ("swiglu", "geglu"):
        ffn["w_gate"] = (d, cfg.d_ff)
    parts = {"norm1": norm, "attn": attn, "norm2": norm, "ffn": ffn}
    if cross:
        parts.update(norm_x=norm, xattn=attn)
    return parts


class _Stack(nn.Module):
    """``layers`` blocks' parameters, each leaf stacked ``[layers, ...]``."""

    def __init__(self, shapes: dict, layers: int, dtype, device):
        super().__init__()
        for part, leaves in shapes.items():
            setattr(self, part, _params({name: (layers,) + shape
                                         for name, shape in leaves.items()},
                                        dtype, device))

    def parts(self) -> List[str]:
        return sorted(name for name, _ in self.named_children())

    def unbind(self) -> List[dict]:
        """Per-layer views ``[{part: {name: tensor}}]`` (one ``unbind``
        per leaf, whose backward is one stack)."""
        per = {part: {name: t.unbind(0)
                      for name, t in getattr(self, part).items()}
               for part in self.parts()}
        layers = len(next(iter(per[self.parts()[0]].values())))
        return [{part: {name: ts[i] for name, ts in leaves.items()}
                 for part, leaves in per.items()} for i in range(layers)]


class Whisper(nn.Module):
    """The encoder-decoder's parameters (uninitialised; see
    :func:`init_params` and :func:`repro_torch.convert.params_from_jax`)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dtype = cfg.param_dtype
        embed = {"table": (cm.pad_vocab(cfg.vocab_size), cfg.d_model)}
        if not cfg.tie_embeddings:
            embed["head"] = (cfg.d_model, cm.pad_vocab(cfg.vocab_size))
        self.embed = _params(embed, dtype, device)
        self.encoder = _Stack(_block_shapes(cfg, False), cfg.encoder_layers,
                              dtype, device)
        self.decoder = _Stack(_block_shapes(cfg, True), cfg.n_layers, dtype,
                              device)
        self.enc_norm = _norm(cfg, dtype, device)
        self.final_norm = _norm(cfg, dtype, device)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Whisper:
    """Random parameters on ``device`` from a seeded ``torch.Generator``,
    scaled as :func:`repro_torch.models.lm.init_params` scales them
    (truncated normals over ``1/sqrt(d_in)``, the table over
    ``1/sqrt(d_model)``, norms at their identity).  The numbers are not
    the reference's ``jax.random`` draws.  On the ``meta`` device the
    parameters have their shapes and no values."""
    dev = resolve_device(device)
    params = Whisper(cfg, dev)
    if dev.type == "meta":           # shapes alone
        return params
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name, p in params.named_parameters():
        leaf = name.split(".")[-1]
        if leaf in ("scale", "bias"):
            p.fill_(1.0 if (leaf == "scale" and cfg.norm != "rms") else 0.0)
            continue
        fan_in = p.shape[1] if leaf == "table" else p.shape[-2]
        p.copy_(cm.trunc_normal(gen, p.shape, dev, 1.0 / math.sqrt(fan_in)))
    return params


def _self_attn(bp, x, cfg, positions, causal, kv_chunk=0):
    h = cm.apply_norm(x, bp["norm1"], cfg.norm)
    out, kv = cm.attention_apply(bp["attn"], h, cfg, positions=positions,
                                 layer_kind="A", apply_rope=False,
                                 causal=causal, kv_chunk=kv_chunk)
    return x + out, kv


def _cross_attn(bp, x, cfg, enc_kv):
    """Cross-attention over the precomputed port-major encoder K/V
    ``[B, Hkv, S_enc, D]``."""
    h = cm.apply_norm(x, bp["norm_x"], cfg.norm)
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    q = (h @ bp["xattn"]["wq"]).reshape(b, s, cfg.n_heads, hd)
    k_pm, v_pm = enc_kv
    kv_pos = torch.arange(k_pm.shape[2], device=x.device)
    valid = torch.ones_like(kv_pos, dtype=torch.bool)
    out = cm._decode_attention(q, k_pm, v_pm, torch.zeros((), device=x.device,
                                                          dtype=torch.int32),
                               kv_pos, valid, 0)
    return x + out.reshape(b, s, cfg.n_heads * hd) @ bp["xattn"]["wo"]


def _mlp(bp, x, cfg):
    h = cm.apply_norm(x, bp["norm2"], cfg.norm)
    return x + cm.mlp_apply(bp["ffn"], h, cfg.mlp)


def _enc_block(bp, x, cfg, positions):
    x, _ = _self_attn(bp, x, cfg, positions, causal=False)
    return _mlp(bp, x, cfg)


def _dec_block(bp, x, ckv, cfg, positions, kv_chunk):
    x, _ = _self_attn(bp, x, cfg, positions, causal=True, kv_chunk=kv_chunk)
    x = _cross_attn(bp, x, cfg, ckv)
    return _mlp(bp, x, cfg)


def _with_positions(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return x + cm.sinusoidal_positions(x.shape[1], cfg.d_model,
                                       x.device).to(x.dtype)


def encode(params: Whisper, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """The encoder over the stub frame embeddings ``[B, S_enc, d]``; each
    block rematerialised in the backward unless ``cfg.remat`` is
    ``"none"``."""
    x = _with_positions(frames.to(cfg.param_dtype), cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    for bp in params.encoder.unbind():
        x = remat(cfg, _enc_block, bp, x, cfg, positions)
    return cm.apply_norm(x, params.enc_norm, cfg.norm)


def _enc_cross_kv(layers: List[dict], enc_out: torch.Tensor,
                  cfg: ModelConfig) -> list:
    """Each decoder layer's cross K/V ``(k_pm, v_pm)``, port-major ``[B,
    Hkv, S_enc, D]``: every layer's K and V computed first, then the list
    of ``2 * n_layers`` leaves banked through the model's fabric in one
    call (one layout-engine launch on the medusa fabric).  The leaves are
    fresh products, so a one-head view aliases nothing else."""
    b, s_enc, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    leaves = []
    for bp in layers:
        for w in ("wk", "wv"):
            leaves.append((enc_out @ bp["xattn"][w]).reshape(
                b, s_enc, cfg.n_kv_heads, hd))
    banked = cm._kv_port_major(leaves, cfg)
    return list(zip(banked[0::2], banked[1::2]))


def forward(params: Whisper, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig, kv_chunk: int = 0) -> torch.Tensor:
    """The training forward: encode ``frames``, decode ``tokens [B, S]`` →
    logits ``[B, S, V]`` (float32, over the padded vocab).  The cross K/V
    of every decoder layer go through the layout engine together, outside
    the rematerialised blocks, so a step launches it once forward and once
    in the backward."""
    enc_out = encode(params, frames, cfg)
    layers = params.decoder.unbind()
    cross_kv = _enc_cross_kv(layers, enc_out, cfg)
    x = _with_positions(cm.embed_apply(params.embed, tokens), cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    for bp, ckv in zip(layers, cross_kv):
        x = remat(cfg, _dec_block, bp, x, ckv, cfg, positions, kv_chunk)
    x = cm.apply_norm(x, params.final_norm, cfg.norm)
    return cm.logits_apply(params.embed, x, cfg)


def init_cache(cfg: ModelConfig, batch: int, t_max: int,
               device=None) -> dict:
    """The decode caches: line-major self-attention ``k``/``v`` ``[L, B,
    t_max, Hkv, D]`` and port-major ``cross_k``/``cross_v`` ``[L, B, Hkv,
    S_enc, D]``."""
    dev = resolve_device(device)
    hd, dt, lay = cfg.resolved_head_dim, cfg.param_dtype, cfg.n_layers
    self_shape = (lay, batch, t_max, cfg.n_kv_heads, hd)
    cross_shape = (lay, batch, cfg.n_kv_heads, cfg.encoder_seq, hd)
    return {"k": torch.zeros(self_shape, dtype=dt, device=dev),
            "v": torch.zeros(self_shape, dtype=dt, device=dev),
            "cross_k": torch.zeros(cross_shape, dtype=dt, device=dev),
            "cross_v": torch.zeros(cross_shape, dtype=dt, device=dev)}


def prefill(params: Whisper, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig, t_max: int):
    """Encode + decoder prefill: returns ``(logits [B, 1, V]`` of the last
    position, the caches)``, the self-attention K/V installed at ``[:,
    :S]`` of depth ``t_max`` and the port-major cross K/V."""
    enc_out = encode(params, frames, cfg)
    layers = params.decoder.unbind()
    cross_kv = _enc_cross_kv(layers, enc_out, cfg)
    b, s = tokens.shape
    if s > t_max:
        raise ValueError(f"prompt of {s} tokens does not fit t_max={t_max}")
    caches = init_cache(cfg, b, t_max, device=tokens.device)
    x = _with_positions(cm.embed_apply(params.embed, tokens), cfg)
    positions = torch.arange(s, device=x.device)
    for i, (bp, ckv) in enumerate(zip(layers, cross_kv)):
        x, kv = _self_attn(bp, x, cfg, positions, causal=True)
        caches["k"][i, :, :s] = kv["k"]
        caches["v"][i, :, :s] = kv["v"]
        x = _mlp(bp, _cross_attn(bp, x, cfg, ckv), cfg)
    caches["cross_k"] = torch.stack([k for k, _ in cross_kv])
    caches["cross_v"] = torch.stack([v for _, v in cross_kv])
    x = cm.apply_norm(x, params.final_norm, cfg.norm)
    return cm.logits_apply(params.embed, x[:, -1:], cfg), caches


def decode_step(params: Whisper, token: torch.Tensor, cache: dict, pos,
                cfg: ModelConfig):
    """One decoder step at the scalar position ``pos``: ``token [B, 1]`` →
    ``(logits [B, 1, V], cache)``; each layer writes the new token's K/V
    into its line-major cache in place and reads the cache through the
    layout engine; the cross K/V stay.  A position outside the cache depth
    raises ``ValueError``."""
    depth = cache["k"].shape[2]
    if not 0 <= int(pos) < depth:
        raise ValueError(f"decode position {int(pos)} is outside the KV "
                         f"cache depth {depth}: size t_max for prompt + "
                         f"generated tokens")
    pos = torch.as_tensor(int(pos), dtype=torch.int32, device=token.device)
    x = cm.embed_apply(params.embed, token)
    x = x + cm.sinusoidal_at(pos, cfg.d_model).to(x.dtype)
    for i, bp in enumerate(params.decoder.unbind()):
        h = cm.apply_norm(x, bp["norm1"], cfg.norm)
        out, _ = cm.attention_apply(
            bp["attn"], h, cfg, positions=pos[None], layer_kind="A",
            cache={"k": cache["k"][i], "v": cache["v"][i], "pos": pos},
            apply_rope=False)
        x = _cross_attn(bp, x + out, cfg,
                        (cache["cross_k"][i], cache["cross_v"][i]))
        x = _mlp(bp, x, cfg)
    x = cm.apply_norm(x, params.final_norm, cfg.norm)
    return cm.logits_apply(params.embed, x, cfg), cache
