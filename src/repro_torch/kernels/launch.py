"""Launch plumbing shared by the kernel wrappers.

Binding a library's C entry point (built at first use by
:mod:`repro_torch.kernels.build`), the current CUDA stream, the checks a
wrapper makes before it hands pointers to a kernel, and the launch counts.

Each kernel keeps a launch count (:func:`launch_counts`), incremented by
its wrapper where it launches the kernel and nowhere else, so a run can show
that its path went through the kernels.  The launches made inside an
autograd backward (:func:`backward_launches`, entered by the backward of
the port's autograd Functions) are counted in the totals and again in
:func:`backward_launch_counts`, so a training step shows how many of its
launches were the adjoint movements.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build

WORD_BYTES = (1, 2, 4, 8)

_launches: Dict[str, int] = {"gather_burst_network_tiles": 0,
                             "scatter_burst_network_tiles": 0,
                             "burst_network_tiles": 0,
                             "medusa_transpose_tiles": 0,
                             "read_network_tiles": 0,
                             "barrel_rotate_groups": 0,
                             "stream_matmul": 0}

_backward: Dict[str, int] = dict.fromkeys(_launches, 0)
_IN_BACKWARD = [0]

_BOUND: Dict[str, object] = {}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_launches)


def backward_launch_counts() -> Dict[str, int]:
    """The launches of :func:`launch_counts` made inside an autograd
    backward (:func:`backward_launches`)."""
    return dict(_backward)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
        _backward[name] = 0


@contextlib.contextmanager
def backward_launches():
    """Count the launches inside the block as backward launches too (the
    backward of an autograd Function wraps its adjoint movement in it)."""
    _IN_BACKWARD[0] += 1
    try:
        yield
    finally:
        _IN_BACKWARD[0] -= 1


def count(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper right
    before the launch)."""
    _launches[name] += 1
    if _IN_BACKWARD[0]:
        _backward[name] += 1


def bind(source: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of the library built from ``source``,
    with its argument and return types declared (bound once per
    process)."""
    fn = _BOUND.get(symbol)
    if fn is None:
        fn = getattr(build.load(source), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _BOUND[symbol] = fn
    return fn


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raw_stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as its raw handle, without
    the ``torch.cuda.Stream`` object :func:`stream` builds."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with "
                           f"cudaError {err}")


def check_cuda(what: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one
    device."""
    dev = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, not a CUDA "
                             f"device")
        if dev is not None and t.device != dev:
            raise ValueError(f"{what}: operands on different devices "
                             f"({dev} and {t.device})")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def word_bytes(t: torch.Tensor, what: str) -> int:
    size = t.element_size()
    if size not in WORD_BYTES:
        raise TypeError(f"{what}: {t.dtype} has a {size}-byte element; the "
                        f"movement kernels move 1, 2, 4 or 8-byte words")
    return size


def row_word(t: torch.Tensor, out: torch.Tensor) -> int:
    """The widest machine word (16, 8, 4, 2 or 1 bytes) that divides a
    payload row's bytes (the last axis) and both buffers' alignment."""
    row = t.shape[-1] * t.element_size()
    for wb in (16, 8, 4, 2, 1):
        if row % wb == 0 and t.data_ptr() % wb == 0 \
                and out.data_ptr() % wb == 0:
            return wb
    return 1
