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

Beside its count a wrapper reports the launch and its operands
(:func:`report`) to the cost census of :mod:`repro_torch.launch.
hlo_analysis`, which cannot see a launch through ``ctypes`` otherwise;
:func:`kernel_cost` prices a launch from its operands.  The port's
collectives report to the same census (:func:`report_collective`).  With
no census listening a report costs one test of an empty list.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Sequence, Tuple

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

# the censuses listening to launches and collectives (entered by
# repro_torch.launch.hlo_analysis.analyze_step): none outside a census
_LISTENERS: list = []


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


@contextlib.contextmanager
def listening(census):
    """Hand every :func:`report` and :func:`report_collective` inside the
    block to ``census`` (its ``kernel(name, operands)`` and
    ``collective(kind, operands, results)``)."""
    _LISTENERS.append(census)
    try:
        yield census
    finally:
        _LISTENERS.remove(census)


def report(name: str, **operands: torch.Tensor) -> None:
    """Report one launch of kernel ``name`` on ``operands`` (the keywords
    of :func:`kernel_cost`) to the listening censuses; called by the
    wrapper beside :func:`count`."""
    for census in _LISTENERS:
        census.kernel(name, operands)


def report_collective(kind: str, operands: Sequence[torch.Tensor],
                      results: Sequence[torch.Tensor]) -> None:
    """Report one collective of the reference's HLO ``kind``
    (``all-to-all``, ``collective-permute``, ``all-reduce``) over every
    rank's ``operands`` and ``results`` to the listening censuses."""
    for census in _LISTENERS:
        census.collective(kind, operands, results)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _live(idx: torch.Tensor, n_lines: int) -> int:
    """The frame indices of ``idx`` that address a line of ``[0,
    n_lines)``: the frames a sparse burst moves (a read of ``idx``)."""
    return int(((idx >= 0) & (idx < n_lines)).sum())


def kernel_cost(name: str, **ops: torch.Tensor) -> Tuple[int, int]:
    """``(bytes, flops)`` of one launch of kernel ``name`` on its operands:
    each input it reads once and each output it writes once, and the
    operations it does.  The operands by kernel: ``lines, idx, out`` (the
    gather: its live frames read, every output frame written, sentinel
    frames as zeros), ``banked, idx, into`` (the scatter: live frames
    read and written, sentinel frames neither), ``tile`` (the dense
    burst), ``leaves`` (the layout engine: every leaf of the launch),
    ``lines`` (the read network), ``x, amounts`` (the rotator), ``x, w,
    out`` (the matmul, ``2·M·N·K`` operations).  The sparse bursts read
    ``idx`` on the host to count their live frames; the others read
    shapes only, so they price ``meta`` tensors too."""
    if name == "gather_burst_network_tiles":
        lines, idx = ops["lines"], ops["idx"]
        frame = nbytes(lines[0]) if lines.shape[0] else 0
        return (_live(idx, lines.shape[0]) * frame + nbytes(idx)
                + nbytes(ops["out"]), 0)
    if name == "scatter_burst_network_tiles":
        into, idx = ops["into"], ops["idx"]
        frame = nbytes(into[0]) if into.shape[0] else 0
        return 2 * _live(idx, into.shape[0]) * frame + nbytes(idx), 0
    if name == "burst_network_tiles":
        return 2 * nbytes(ops["tile"]), 0
    if name == "medusa_transpose_tiles":
        return 2 * sum(nbytes(x) for x in ops["leaves"]), 0
    if name == "read_network_tiles":
        return 2 * nbytes(ops["lines"]), 0
    if name == "barrel_rotate_groups":
        return 2 * nbytes(ops["x"]) + nbytes(ops["amounts"]), 0
    if name == "stream_matmul":
        x, w = ops["x"], ops["w"]
        m, k = x.shape
        return (nbytes(x) + nbytes(w) + nbytes(ops["out"]),
                2 * m * w.shape[1] * k)
    raise KeyError(f"no cost model for kernel {name!r}")


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
