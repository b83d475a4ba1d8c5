"""Plain oracles of the kernels (port of ``repro.kernels.ref``).

Each function is the semantic ground truth a kernel and its plain version
are held against.  The burst ops' oracles live in
:mod:`repro_torch.core.transpose`.
"""

from __future__ import annotations

import torch


def transpose_ref(x: torch.Tensor) -> torch.Tensor:
    """Oracle of the layout engine: swap the two leading axes of a ``[R,
    C, W]`` (payload-trailing) tensor."""
    return x.transpose(0, 1)


def rotate_ref(x: torch.Tensor, amount) -> torch.Tensor:
    """Oracle of the barrel rotator: left rotation along axis 0."""
    return torch.roll(x, -int(amount), 0)


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Oracle of the streaming matmul: the float32 product, cast to
    ``x.dtype``."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def kv_layout_ref(kv: torch.Tensor) -> torch.Tensor:
    """Oracle of the KV-cache layout engine: line-major ``[T, H, D]`` →
    port-major ``[H, T, D]``."""
    return kv.transpose(0, 1)
