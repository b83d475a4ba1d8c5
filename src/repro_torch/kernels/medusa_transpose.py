"""The Medusa kernels on Hopper, with their plain PyTorch versions.

Four CUDA kernels (sources in ``csrc/``) replace the Pallas kernels of
``repro.kernels.medusa_transpose``:

* :func:`gather_burst_network_tiles` — fused page-table gather + read
  network (``csrc/gather_burst.cu``);
* :func:`scatter_burst_network_tiles` — fused write network + page-table
  scatter, in place (``csrc/scatter_burst.cu``);
* :func:`burst_network_tiles` — the dense ``[N, N, W]`` burst, an
  involution serving both directions (``csrc/burst_network.cu``);
* :func:`medusa_transpose_tiles` — the KV-cache layout engine, ``[B, R, C,
  W] → [B, C, R, W]`` (``csrc/medusa_transpose.cu``), on the per-layer
  decode path.

Each wrapper takes its plain version (``*_plain``, index / where / permute
on tensors) for a tensor on the CPU, launches its kernel for a CUDA tensor,
and raises on anything it cannot take.  There is no fallback from the
kernel to the plain version.  The kernels move machine words: a payload of
any dtype is viewed as the unsigned word of its width (1, 2, 4 or 8 bytes),
so one instance per width serves every dtype.

Each kernel keeps a launch count (:func:`launch_counts`), incremented where
the kernel is launched and nowhere else, so a run can show that its path
went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core.transpose import read_network_oracle
from repro_torch.kernels import build

_WORD_BYTES = (1, 2, 4, 8)

_launches: Dict[str, int] = {"gather_burst_network_tiles": 0,
                             "scatter_burst_network_tiles": 0,
                             "burst_network_tiles": 0,
                             "medusa_transpose_tiles": 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _word_bytes(t: torch.Tensor, what: str) -> int:
    size = t.element_size()
    if size not in _WORD_BYTES:
        raise TypeError(f"{what}: {t.dtype} has a {size}-byte element; the "
                        f"burst kernels move 1, 2, 4 or 8-byte words")
    return size


def _check_cuda(what: str, **tensors: torch.Tensor) -> None:
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


# C signatures: (src, idx, dst, n_lines, N, count, W, word_bytes, stream)
# for the sparse kernels, (src, dst, N, W, word_bytes, stream) for the dense
_SPARSE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_DENSE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


_BOUND: Dict[str, object] = {}


def _bind(source: str, symbol: str, argtypes):
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


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with "
                           f"cudaError {err}")


def _check_idx(idx: torch.Tensor, what: str) -> None:
    if idx.dtype != torch.int32 or idx.ndim != 1:
        raise TypeError(f"{what}: indices must be int32 [K], got "
                        f"{idx.dtype} {tuple(idx.shape)}")


def _valid(idx: torch.Tensor, n_lines: int) -> torch.Tensor:
    return (idx >= 0) & (idx < n_lines)


# ----------------------------------------------------------------------------
# 1. fused gather + read network
# ----------------------------------------------------------------------------

def gather_burst_plain(lines: torch.Tensor, idx: torch.Tensor,
                       n_ports: int) -> torch.Tensor:
    """Plain version: take the addressed frames (zero frames at sentinels)
    and run the read network oracle on them."""
    valid = _valid(idx, lines.shape[0])
    taken = lines.index_select(0, torch.where(valid, idx, 0).long())
    taken = torch.where(valid.view(-1, 1, 1), taken, torch.zeros_like(taken))
    return read_network_oracle(taken, n_ports).contiguous()


def gather_burst_network_tiles(lines: torch.Tensor, idx: torch.Tensor,
                               n_ports: int) -> torch.Tensor:
    """Fused gather + read network: pool lines ``[L, N, W]`` and frame
    indices ``idx int32 [K]`` (K a multiple of N; entries outside ``[0,
    L)`` are sentinels) → banked ``[K//N, N, N, W]`` with ``out[g, y, p] =
    lines[idx[g*N + p], y]``, zero frames at sentinels."""
    n = n_ports
    if lines.ndim != 3 or lines.shape[1] != n or idx.shape[0] % n:
        raise ValueError(f"bad gather burst: lines {tuple(lines.shape)}, "
                         f"idx {tuple(idx.shape)} for N={n}")
    _check_idx(idx, "gather_burst_network_tiles")
    if lines.device.type == "cpu" and idx.device.type == "cpu":
        return gather_burst_plain(lines, idx, n)
    _check_cuda("gather_burst_network_tiles", lines=lines, idx=idx)
    wb = _word_bytes(lines, "gather_burst_network_tiles")
    l, _, w = lines.shape
    k = idx.shape[0]
    out = torch.empty((k // n, n, n, w), dtype=lines.dtype,
                      device=lines.device)
    fn = _bind("gather_burst", "medusa_gather_burst", _SPARSE_ARGS)
    _launches["gather_burst_network_tiles"] += 1
    _raise_on(fn(lines.data_ptr(), idx.data_ptr(), out.data_ptr(), l, n, k, w,
                 wb, _stream(lines)), "gather_burst_network_tiles")
    return out


# ----------------------------------------------------------------------------
# 2. fused write network + scatter (in place)
# ----------------------------------------------------------------------------

def scatter_burst_plain(banked: torch.Tensor, idx: torch.Tensor,
                        into: torch.Tensor, n_ports: int) -> torch.Tensor:
    """Plain version: the write network oracle, then the live lines land at
    their rows of ``into`` in place (sentinels drop)."""
    g = banked.shape[0]
    lines = banked.transpose(1, 2).reshape((g * n_ports,) + into.shape[1:])
    valid = _valid(idx, into.shape[0])
    into[idx[valid].long()] = lines[valid]
    return into


def scatter_burst_network_tiles(banked: torch.Tensor, idx: torch.Tensor,
                                into: torch.Tensor,
                                n_ports: int) -> torch.Tensor:
    """Fused write network + scatter: banked ``[G, N, N, W]`` → line frames
    written into the pool stream ``into [L, N, W]`` **in place** at rows
    ``idx int32 [G*N]`` (``into[idx[g*N + r], y] = banked[g, y, r]``);
    sentinel entries (outside ``[0, L)``) drop, and rows no index names keep
    their bytes.  Returns ``into``.

    Live indices must be unique — the page pool never maps a physical frame
    twice.  The kernel's blocks run concurrently, so with a duplicate the
    frame that lands would be unspecified."""
    n = n_ports
    g, n0, n1, w = banked.shape
    if n0 != n or n1 != n or idx.shape[0] != g * n:
        raise ValueError(f"bad scatter burst: banked {tuple(banked.shape)}, "
                         f"idx {tuple(idx.shape)} for N={n}")
    if into.ndim != 3 or into.shape[1] != n or into.shape[2] != w:
        raise ValueError(f"scatter target {tuple(into.shape)} does not match "
                         f"banked frames [{n}, {w}]")
    if into.dtype != banked.dtype:
        raise TypeError(f"scatter target {into.dtype} != banked "
                        f"{banked.dtype}")
    _check_idx(idx, "scatter_burst_network_tiles")
    if all(t.device.type == "cpu" for t in (banked, idx, into)):
        return scatter_burst_plain(banked, idx, into, n)
    _check_cuda("scatter_burst_network_tiles", banked=banked, idx=idx,
                into=into)
    wb = _word_bytes(banked, "scatter_burst_network_tiles")
    fn = _bind("scatter_burst", "medusa_scatter_burst", _SPARSE_ARGS)
    _launches["scatter_burst_network_tiles"] += 1
    _raise_on(fn(banked.data_ptr(), idx.data_ptr(), into.data_ptr(),
                 into.shape[0], n, g, w, wb, _stream(banked)),
              "scatter_burst_network_tiles")
    return into


# ----------------------------------------------------------------------------
# 3. dense burst (read and write network)
# ----------------------------------------------------------------------------

def burst_network_plain(tile: torch.Tensor, n_ports: int) -> torch.Tensor:
    """Plain version: the ``[N, N]`` transpose of the tile."""
    return tile.transpose(0, 1).contiguous()


def burst_network_tiles(tile: torch.Tensor, n_ports: int) -> torch.Tensor:
    """One packed burst ``[N, N, W]`` through the transposition unit:
    ``out[y, p] = tile[p, y]``.  An involution, so the same kernel is the
    read and the write network."""
    n = n_ports
    if tile.ndim != 3 or tile.shape[0] != n or tile.shape[1] != n:
        raise ValueError(f"bad burst tile {tuple(tile.shape)} for N={n}")
    if tile.device.type == "cpu":
        return burst_network_plain(tile, n)
    _check_cuda("burst_network_tiles", tile=tile)
    wb = _word_bytes(tile, "burst_network_tiles")
    out = torch.empty_like(tile)
    fn = _bind("burst_network", "medusa_burst_network", _DENSE_ARGS)
    _launches["burst_network_tiles"] += 1
    _raise_on(fn(tile.data_ptr(), out.data_ptr(), n, tile.shape[2], wb,
                 _stream(tile)), "burst_network_tiles")
    return out


# ----------------------------------------------------------------------------
# 4. the KV-cache layout engine (line-major → port-major)
# ----------------------------------------------------------------------------

_TRANSPOSE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]


def medusa_transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: swap the two axes before the payload axis, into a
    contiguous tensor (``[..., R, C, W] → [..., C, R, W]``)."""
    return x.transpose(-3, -2).contiguous()


def _row_word(t: torch.Tensor, out: torch.Tensor) -> int:
    """The widest machine word (16, 8, 4, 2 or 1 bytes) that divides a
    payload row's bytes and both buffers' alignment."""
    row = t.shape[-1] * t.element_size()
    for wb in (16, 8, 4, 2, 1):
        if row % wb == 0 and t.data_ptr() % wb == 0 \
                and out.data_ptr() % wb == 0:
            return wb
    return 1


def medusa_transpose_tiles(x: torch.Tensor) -> torch.Tensor:
    """Transpose the two leading axes of ``x [R, C, W]`` → ``[C, R, W]``,
    or of every batch row of ``x [B, R, C, W]`` → ``[B, C, R, W]`` in one
    launch.  The kernel computes the permutation directly, so R and C may
    be any size (the reference's Pallas kernel wants multiples of a
    power-of-two tile).  Returns a contiguous tensor of ``x``'s dtype."""
    if x.ndim not in (3, 4):
        raise ValueError(f"transpose wants [R, C, W] or [B, R, C, W], got "
                         f"{tuple(x.shape)}")
    r, c = x.shape[-3], x.shape[-2]
    if x.device.type == "cpu":
        return medusa_transpose_plain(x)
    _check_cuda("medusa_transpose_tiles", x=x)
    _word_bytes(x, "medusa_transpose_tiles")
    out = torch.empty(x.shape[:-3] + (c, r, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    wb = _row_word(x, out)
    b = x.shape[0] if x.ndim == 4 else 1
    fn = _bind("medusa_transpose", "medusa_transpose", _TRANSPOSE_ARGS)
    _launches["medusa_transpose_tiles"] += 1
    _raise_on(fn(x.data_ptr(), out.data_ptr(), b, r, c,
                 x.shape[-1] * x.element_size() // wb, wb, _stream(x)),
              "medusa_transpose_tiles")
    return out
