"""RG-LRU recurrent block (port of ``repro.models.rglru``; RecurrentGemma /
Griffin, arXiv:2402.19427).

The recurrence ``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)`` with
``a_t = exp(-c * softplus(Lambda) * r_t)`` is linear in ``h``.  The
reference runs prefill as ``jax.lax.associative_scan``; PyTorch has none,
so prefill here is a Hillis-Steele scan of the same combine over the
sequence axis: ``log2(S)`` rounds of whole-tensor ops instead of a loop of
``S`` small ones.  Its products associate in another order than JAX's
tree, so the two agree within float32 rounding, not bit for bit.  Decode
is the one-step recurrence on an O(1) state.

Block: an input projection to two branches of width ``lru_width``; branch
1 passes a short causal conv (:func:`repro_torch.models.mamba2.
_causal_conv`, as the reference's) and the RG-LRU, branch 2 is a GeLU
gate; their product projects back to ``d_model``.  The gate weights, their
biases and ``lam`` are float32 in any model dtype, as is the ``h`` cache.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.mamba2 import _causal_conv, softplus


def _width(cfg) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def rglru_param_shapes(cfg, dtype) -> dict:
    """``{name: (shape, dtype)}`` of one block's parameters, the
    reference's tree."""
    w, d, f32 = _width(cfg), cfg.d_model, torch.float32
    return {"w_branch": ((d, 2 * w), dtype),
            "conv_w": ((cfg.rglru.conv_width, w), dtype),
            "conv_b": ((w,), dtype), "w_a": ((w, w), f32), "b_a": ((w,), f32),
            "w_i": ((w, w), f32), "b_i": ((w,), f32), "lam": ((w,), f32),
            "w_out": ((w, d), dtype)}


def rglru_init_(p, generator: torch.Generator) -> None:
    """Fill one block's parameters in place as the reference initialises
    them: projections and gates truncated normal over ``1/sqrt(d_in)``,
    the conv taps over 0.1, ``lam = linspace(2, 6, W)``, the biases zeros.
    The random draws are not the reference's ``jax.random`` numbers."""
    for name, t in p.items():
        if name in ("w_branch", "w_a", "w_i", "w_out"):
            t.copy_(cm.trunc_normal(generator, t.shape, t.device,
                                    1.0 / math.sqrt(t.shape[0])))
        elif name == "conv_w":
            t.copy_(cm.trunc_normal(generator, t.shape, t.device, 0.1))
        elif name == "lam":
            t.copy_(torch.linspace(2.0, 6.0, t.shape[0]))
        else:                                       # conv_b, b_a, b_i
            t.zero_()


def _gates(p, xb: torch.Tensor, cfg):
    """The recurrence's decay ``a`` and input ``b`` (float32)."""
    xf = xb.float()
    r_gate = torch.sigmoid(xf @ p["w_a"] + p["b_a"])
    i_gate = torch.sigmoid(xf @ p["w_i"] + p["b_i"])
    log_a = -cfg.rglru.c * softplus(p["lam"]) * r_gate
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i_gate * xf)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` from ``h_{-1} = 0`` along axis 1, for
    every ``t``: Hillis-Steele over the combine ``(a, b) o (a', b') =
    (a a', a' b + b')``, the reference's ``associative_scan`` operator.
    Each round builds new tensors (``torch.cat`` of the untouched head and
    the combined tail) rather than writing slices in place, so autograd
    can differentiate through the scan."""
    step = 1
    while step < a.shape[1]:
        b = torch.cat([b[:, :step], a[:, step:] * b[:, :-step] + b[:, step:]],
                      dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
        step *= 2
    return b


def rglru_apply(p, xin: torch.Tensor, cfg, cache=None):
    """One Griffin recurrent block on ``xin [B, S, d]``.  Prefill
    (``cache`` None) returns ``(out, None)``; decode (``S == 1``) takes
    ``cache = {"conv": [B, K-1, W], "h": [B, W]}`` and returns ``(out,
    {"conv", "h"})``."""
    w = _width(cfg)
    xb, gate = torch.split(xin @ p["w_branch"], [w, w], dim=-1)
    if cache is None:
        xb, _ = _causal_conv(xb, p["conv_w"], p["conv_b"])
        a, bb = _gates(p, xb, cfg)
        h = linear_scan(a, bb)
        new_cache = None
    else:
        xb, new_conv = _causal_conv(xb, p["conv_w"], p["conv_b"],
                                    cache["conv"])
        a, bb = _gates(p, xb, cfg)
        h = a[:, 0] * cache["h"] + bb[:, 0]
        new_cache = {"conv": new_conv, "h": h}
        h = h[:, None]
    out = h.to(xin.dtype) * F.gelu(gate, approximate="tanh")
    return out @ p["w_out"], new_cache


def final_state(p, xin: torch.Tensor, cfg) -> dict:
    """The decode cache after prefilling ``xin [B, S, d]`` (the block's
    normed input), by the reference's ``_recover_rec_state`` formulas: the
    last ``K-1`` branch-1 inputs (zero-padded on the left when ``S <
    K-1``) and the scan's last ``h``."""
    b, seqlen, _ = xin.shape
    w = _width(cfg)
    k1 = cfg.rglru.conv_width - 1
    xb, _ = torch.split(xin @ p["w_branch"], [w, w], dim=-1)
    conv_state = torch.cat(
        [xb.new_zeros((b, max(k1 - seqlen, 0), w)),
         xb[:, seqlen - min(k1, seqlen):]], dim=1)
    xbc, _ = _causal_conv(xb, p["conv_w"], p["conv_b"])
    a, bb = _gates(p, xbc, cfg)
    return {"conv": conv_state, "h": linear_scan(a, bb)[:, -1]}


def rglru_sequential_ref(p, xin: torch.Tensor, cfg) -> torch.Tensor:
    """The step-by-step recurrence the scan computes (tests only)."""
    b, seq, _ = xin.shape
    w = _width(cfg)
    xb, gate = torch.split(xin @ p["w_branch"], [w, w], dim=-1)
    xb, _ = _causal_conv(xb, p["conv_w"], p["conv_b"])
    a, bb = _gates(p, xb, cfg)
    h = torch.zeros((b, w), dtype=torch.float32, device=xin.device)
    hs = []
    for t in range(seq):
        h = a[:, t] * h + bb[:, t]
        hs.append(h)
    h = torch.stack(hs, dim=1)
    out = h.to(xin.dtype) * F.gelu(gate, approximate="tanh")
    return out @ p["w_out"]
