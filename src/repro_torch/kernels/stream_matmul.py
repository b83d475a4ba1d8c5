"""The streaming matmul on Hopper (port of ``repro.kernels.stream_matmul``,
the paper's layer processor).

:func:`stream_matmul` computes ``x [M, K] @ w [K, N]`` with a float32
accumulator and casts to ``x.dtype``: one launch of the CUDA kernel
``csrc/stream_matmul.cu`` for CUDA tensors, the plain version for CPU
tensors.  The supported pairs are (bf16, bf16) and (float32, float32); any
other pair raises rather than being cast.  Every route takes any M, N and
K, so the reference's block sizes ``bm, bn, bk`` — properties of its Pallas
grid — have no counterpart here.

:func:`route` picks the kernel from the dtype, the shape and the operands'
alignment alone:

=========  ============================================================
route      operands
=========  ============================================================
fma        float32 (exact fp32 FMA on the CUDA cores, no TF32)
mma_sync   bf16 that TMA cannot describe: K == 0, K % 8, N % 8, or a base
           not 16-byte aligned
small_m    bf16, otherwise, M <= SMALL_M (a stream of w: decode)
wgmma      bf16, otherwise, M > SMALL_M (TMA + wgmma)
=========  ============================================================
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import launch as kl
from repro_torch.kernels.ref import matmul_ref

_DTYPES = (torch.float32, torch.bfloat16)
# the C entry point's route numbers
ROUTES = {"fma": 0, "mma_sync": 1, "small_m": 2, "wgmma": 3}
# the largest M of the small-M route (its kernel keeps at most 16 rows)
SMALL_M = 16
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


def route(m: int, n: int, k: int, dtype: torch.dtype, x_ptr: int,
          w_ptr: int) -> str:
    """The kernel that computes ``[m, k] @ [k, n]`` of ``dtype`` from bases
    ``x_ptr`` and ``w_ptr`` (see the module's table)."""
    if dtype == torch.float32:
        return "fma"
    if k == 0 or k % 8 or n % 8 or x_ptr % 16 or w_ptr % 16:
        return "mma_sync"
    return "small_m" if m <= SMALL_M else "wgmma"


def stream_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: the float32 product, cast to ``x.dtype``."""
    _check(x, w)
    return matmul_ref(x, w)


def stream_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` with a float32 accumulator, cast to
    ``x.dtype``; both operands bf16 or both float32, any M, N, K.  One
    launch of the kernel :func:`route` picks; returns a contiguous ``[M,
    N]`` tensor."""
    _check(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return matmul_ref(x, w)
    kl.check_cuda("stream_matmul", x=x, w=w)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = kl.bind("stream_matmul", "medusa_stream_matmul", _ARGS)
    kl.count("stream_matmul")
    kl.report("stream_matmul", x=x, w=w, out=out)
    r = route(m, n, k, x.dtype, x.data_ptr(), w.data_ptr())
    kl.raise_on(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                   ROUTES[r], kl.stream(x)), f"stream_matmul ({r})")
    return out
