"""The plain reference: a dense pre-norm decoder in float32, plain PyTorch.

It follows the configuration file as run (the source's widths, with the
departures the file lists) and reads the weights the benchmark made from
the seed, by the benchmark's own names (:mod:`bench.harness.weights`),
upcast to float32 one layer at a time.  It imports nothing of the program.

Per layer: layer norm (float32, the file's epsilon), Q/K/V projections
(``x @ w``), rotary embedding of the first ``partial_rotary_factor`` of
each head (rotate-half pairing, angles in float64), causal grouped-query
attention in float32 (query blocks, so a 6k-token sequence fits), the
output projection, the residual; layer norm, the MLP (SiLU-gated or
tanh-GELU), the residual.  Then the final norm and the head (the
embedding table when tied).  Matrix products run in float32 with TF32 off.

``quant="fp8"`` is the control: the same computation with every matrix
product's operands rounded to float8 e4m3 (weights per output channel,
activations per token, each scaled to the format's largest value), the
precision a later change might be tempted to serve in.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from bench.yardstick.model_cost import widths

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to the format's largest value)."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Mat:
    """Matrix products of one precision: plain float32, or the fp8
    control's rounded operands."""

    def __init__(self, quant: Optional[str]):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown reference precision {quant!r}")
        self.quant = quant

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _fp8(w, 0) if self.quant else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (_fp8(x, -1) if self.quant else x) @ w


def _layer_norm(x, scale, bias, eps):
    return F.layer_norm(x, (x.shape[-1],), scale.float(), bias.float(), eps)


def _rope_tables(n: int, rot: int, theta: float, device):
    """cos/sin ``[n, rot // 2]`` for positions ``0..n-1`` (angles in
    float64)."""
    half = rot // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=device) / half)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def _rope(x, cos, sin, rot: int):
    """Rotate-half rotary embedding on the first ``rot`` channels of each
    head of ``x [T, H, D]``."""
    half = rot // 2
    x1, x2, rest = x[..., :half], x[..., half:rot], x[..., rot:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, rest], dim=-1)


def _attention(q, k, v, q_block: int):
    """Causal attention, ``q [T, H, D]``, ``k/v [T, Hkv, D]`` (heads share
    a K/V head in groups of ``H // Hkv``), float32, in query blocks."""
    t, h, d = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)      # [H, T, D]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    q = q.transpose(0, 1) * (1.0 / math.sqrt(d))           # [H, T, D]
    out = torch.empty_like(q)
    for a in range(0, t, q_block):
        b = min(t, a + q_block)
        s = q[:, a:b] @ k[:, :b].transpose(1, 2)             # [H, qb, b]
        qpos = torch.arange(a, b, device=q.device)[:, None]
        kpos = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        out[:, a:b] = torch.softmax(s, dim=-1) @ v[:, :b]
    return out.transpose(0, 1)                               # [T, H, D]


def forward_logits(cfg: dict, weight: Callable[[str], torch.Tensor],
                   seqs: Sequence[torch.Tensor], first: Sequence[int], *,
                   quant: Optional[str] = None,
                   q_block: int = 512) -> List[torch.Tensor]:
    """Logits ``[len(seq) - first, V]`` (float32, the real vocabulary) of
    each sequence ``seqs[i]`` (token ids on the weights' device) at
    positions ``first[i]`` onward.  ``weight(name)`` returns the weight the
    benchmark made under ``name``."""
    w = widths(cfg)
    ref = cfg["reference"]
    eps = ref["norm_eps"]
    rot = int(w.head_dim * cfg.get("partial_rotary_factor", 1.0))
    mat = _Mat(quant)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        table = weight("embed.table")
        dev = table.device
        longest = max(int(s.shape[0]) for s in seqs)
        cos, sin = _rope_tables(longest, rot, float(cfg["rope_theta"]), dev)
        xs = [table[s.long()].float() for s in seqs]
        for i in range(w.layers):
            p = f"layers.{i}."
            wq, wk, wv, wo = (mat.weight(weight(p + "attn." + n))
                              for n in ("wq", "wk", "wv", "wo"))
            for j, x in enumerate(xs):
                t = x.shape[0]
                h = _layer_norm(x, weight(p + "norm1.scale"),
                                weight(p + "norm1.bias"), eps)
                q = mat(h, wq).view(t, w.heads, w.head_dim)
                k = mat(h, wk).view(t, w.kv_heads, w.head_dim)
                v = mat(h, wv).view(t, w.kv_heads, w.head_dim)
                q = _rope(q, cos[:t], sin[:t], rot)
                k = _rope(k, cos[:t], sin[:t], rot)
                a = _attention(q, k, v, q_block).reshape(t, -1)
                xs[j] = x + mat(a, wo)
            del wq, wk, wv, wo
            names = ("w_gate", "w_up", "w_out") if w.gated \
                else ("w_up", "w_out")
            mlp = {n: mat.weight(weight(p + "ffn." + n)) for n in names}
            for j, x in enumerate(xs):
                h = _layer_norm(x, weight(p + "norm2.scale"),
                                weight(p + "norm2.bias"), eps)
                if w.gated:
                    u = F.silu(mat(h, mlp["w_gate"])) * mat(h, mlp["w_up"])
                else:
                    u = F.gelu(mat(h, mlp["w_up"]), approximate="tanh")
                xs[j] = x + mat(u, mlp["w_out"])
            del mlp
        head = mat.weight(table.t() if w.tied else weight("embed.head"))
        out = []
        for x, f in zip(xs, first):
            h = _layer_norm(x[f:], weight("final_norm.scale"),
                            weight("final_norm.bias"), eps)
            out.append(mat(h, head)[:, :w.vocab])
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
