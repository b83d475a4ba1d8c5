"""Gradient compression: int8 quantisation with error feedback (port of
``repro.runtime.compression``).

Each tensor quantises to int8 with one float32 scale (``max|g| / 127``);
the quantisation residual is carried in an error-feedback buffer and added
to the next step's gradient, so the error does not accumulate.  Pure
functions over lists of tensors.  The data-parallel gradient mean
(``repro_torch.parallel.collectives.compressed_psum``) quantises with a
scale shared across ranks instead, as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch


def int8_quantize(g: torch.Tensor):
    """``(q int8, scale float32)`` with ``q = clip(round(g / scale),
    -127, 127)`` (round half to even, as ``jnp.round``)."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@dataclasses.dataclass
class ErrorFeedback:
    buf: List[torch.Tensor]

    @staticmethod
    def init(grads: Sequence[torch.Tensor]) -> "ErrorFeedback":
        return ErrorFeedback([torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device) for g in grads])


def compress_grads(grads: Sequence[torch.Tensor], ef: ErrorFeedback):
    """Quantise each gradient plus its carried error.  Returns ``([(q,
    scale)], new ErrorFeedback)``; the residual is ``g - dequant(quant(g))``
    of the error-corrected gradient."""
    pairs, resid = [], []
    for g, e in zip(grads, ef.buf):
        g32 = g.float() + e
        q, scale = int8_quantize(g32)
        pairs.append((q, scale))
        resid.append(g32 - int8_dequantize(q, scale))
    return pairs, ErrorFeedback(resid)


def decompress_grads(pairs) -> List[torch.Tensor]:
    return [int8_dequantize(q, scale) for q, scale in pairs]
