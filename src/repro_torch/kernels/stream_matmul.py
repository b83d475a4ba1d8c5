"""The streaming matmul on Hopper (port of ``repro.kernels.stream_matmul``,
the paper's layer processor).

:func:`stream_matmul` computes ``x [M, K] @ w [K, N]`` with a float32
accumulator and casts to ``x.dtype``: the CUDA kernel
``csrc/stream_matmul.cu`` for CUDA tensors (tensor cores for bf16, plain
fp32 FMA for float32), the plain version for CPU tensors.  The supported
pairs are (bf16, bf16) and (float32, float32); any other pair raises rather
than being cast.  The kernel takes any M, N and K (its loads are
bounds-checked and zero-filled), so the reference's block sizes ``bm, bn,
bk`` — properties of its Pallas grid — have no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import launch as kl
from repro_torch.kernels.ref import matmul_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul wants x [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"matmul takes (bfloat16, bfloat16) or (float32, "
                        f"float32) operands, got ({x.dtype}, {w.dtype})")
    if max(x.shape + w.shape) >= 2 ** 31:
        raise ValueError(f"matmul dimensions must be below 2^31, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")


def stream_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: the float32 product, cast to ``x.dtype``."""
    _check(x, w)
    return matmul_ref(x, w)


def stream_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` with a float32 accumulator, cast to
    ``x.dtype``; both operands bf16 or both float32, any M, N, K.  One
    launch; returns a contiguous ``[M, N]`` tensor."""
    _check(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return matmul_ref(x, w)
    kl.check_cuda("stream_matmul", x=x, w=w)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = kl.bind("stream_matmul", "medusa_stream_matmul", _ARGS)
    kl.count("stream_matmul")
    kl.raise_on(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                   _DTYPES[x.dtype], kl.stream(x)), "stream_matmul")
    return out
