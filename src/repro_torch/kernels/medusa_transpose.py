"""The Medusa kernels on Hopper, with their plain PyTorch versions.

Five CUDA kernels (sources in ``csrc/``) replace the Pallas kernels of
``repro.kernels.medusa_transpose``:

* :func:`gather_burst_network_tiles` — fused page-table gather + read
  network (``csrc/gather_burst.cu``);
* :func:`scatter_burst_network_tiles` — fused write network + page-table
  scatter, in place (``csrc/scatter_burst.cu``);
* :func:`burst_network_tiles` — the dense ``[N, N, W]`` burst, an
  involution serving both directions (``csrc/burst_network.cu``);
* :func:`medusa_transpose_many` — the KV-cache layout engine, ``[B, R,
  C, W] → [B, C, R, W]`` for a list of leaves in one launch
  (``csrc/medusa_transpose.cu``), on the per-layer decode path, and
  :func:`medusa_transpose_tiles`, the list of one;
* :func:`read_network_tiles` — the read network on group tiles, line
  stream ``[L, N, W]`` → banked ``[L/N, N, N, W]`` (``csrc/read_network.cu``),
  behind ``ops.interconnect_read``.

Each wrapper takes its plain version (``*_plain``, index / where / permute
on tensors) for a tensor on the CPU, launches its kernel for a CUDA tensor,
and raises on anything it cannot take.  There is no fallback from the
kernel to the plain version.  The kernels move machine words: a payload of
any dtype is viewed as an unsigned word, so one instance per width serves
every dtype; each wrapper views a payload row as the widest word (up to 16
bytes) dividing its bytes and both buffers' alignment.

Each kernel keeps a launch count (:func:`launch_counts`, kept for every
kernel of the port in :mod:`repro_torch.kernels.launch`), incremented where
the kernel is launched and nowhere else, so a run can show that its path
went through the kernels.
"""

from __future__ import annotations

import array
import ctypes

import torch

from repro_torch.core.transpose import (_check_line_stream, _num_stages,
                                        read_network_oracle)
from repro_torch.kernels import launch as kl
from repro_torch.kernels.launch import (  # noqa: F401
    backward_launch_counts, launch_counts, reset_launch_counts)

# C signatures: (src, idx, dst, n_lines, N, count, row words, row word
# bytes, stream) for the sparse kernels (count: the gather's frames, the
# scatter's groups), (src, dst, N, row words, row word bytes, stream) for
# the dense
_SPARSE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_DENSE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


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
    indices ``idx int32 [K]`` (K a multiple of N) → banked ``[K//N, N, N,
    W]`` with ``out[g, y, p] = lines[idx[g*N + p], y]``, zero frames at
    sentinels.

    Every index outside ``[0, L)``, negative ones included, is a sentinel
    here.  The reference takes only indices ``>= L`` as sentinels and wraps
    a negative index as Python indexing does; no caller emits one
    (``page_live_plan`` refuses a table that would, and the fabric's
    sentinel is ``FRAME_SENTINEL = 2**30``).  The kernel copies whole
    frames, each row moved as the widest word (up to 16 bytes) dividing its
    bytes and both buffers' alignment."""
    n = n_ports
    if lines.ndim != 3 or lines.shape[1] != n or idx.shape[0] % n:
        raise ValueError(f"bad gather burst: lines {tuple(lines.shape)}, "
                         f"idx {tuple(idx.shape)} for N={n}")
    _check_idx(idx, "gather_burst_network_tiles")
    if lines.device.type == "cpu" and idx.device.type == "cpu":
        return gather_burst_plain(lines, idx, n)
    kl.check_cuda("gather_burst_network_tiles", lines=lines, idx=idx)
    kl.word_bytes(lines, "gather_burst_network_tiles")
    l, _, w = lines.shape
    k = idx.shape[0]
    out = torch.empty((k // n, n, n, w), dtype=lines.dtype,
                      device=lines.device)
    wb = kl.row_word(lines, out)
    fn = kl.bind("gather_burst", "medusa_gather_burst", _SPARSE_ARGS)
    kl.count("gather_burst_network_tiles")
    kl.report("gather_burst_network_tiles", lines=lines, idx=idx, out=out)
    kl.raise_on(fn(lines.data_ptr(), idx.data_ptr(), out.data_ptr(), l, n, k,
                   w * lines.element_size() // wb, wb, kl.stream(lines)),
                "gather_burst_network_tiles")
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
    sentinel entries drop, and rows no index names keep their bytes.
    Returns ``into``.

    Every index outside ``[0, L)``, negative ones included, is a sentinel
    here.  The reference takes only indices ``>= L`` as sentinels and wraps
    a negative index as Python indexing does; no caller emits one
    (``page_live_plan`` refuses a table that would, and the fabric's
    sentinel is ``FRAME_SENTINEL = 2**30``).

    Live indices must be unique — the page pool never maps a physical frame
    twice.  The kernel's blocks run concurrently, so with a duplicate the
    frame that lands would be unspecified.  The kernel copies whole frames,
    each row moved as the widest word (up to 16 bytes) dividing its bytes
    and both buffers' alignment."""
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
    kl.check_cuda("scatter_burst_network_tiles", banked=banked, idx=idx,
                into=into)
    kl.word_bytes(banked, "scatter_burst_network_tiles")
    wb = kl.row_word(banked, into)
    fn = kl.bind("scatter_burst", "medusa_scatter_burst", _SPARSE_ARGS)
    kl.count("scatter_burst_network_tiles")
    kl.report("scatter_burst_network_tiles", banked=banked, idx=idx,
              into=into)
    kl.raise_on(fn(banked.data_ptr(), idx.data_ptr(), into.data_ptr(),
                   into.shape[0], n, g, w * banked.element_size() // wb, wb,
                   kl.stream(banked)), "scatter_burst_network_tiles")
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
    read and the write network.  The kernel copies N² rows, each moved as
    the widest word (up to 16 bytes) dividing its bytes and both buffers'
    alignment."""
    n = n_ports
    if tile.ndim != 3 or tile.shape[0] != n or tile.shape[1] != n:
        raise ValueError(f"bad burst tile {tuple(tile.shape)} for N={n}")
    if tile.device.type == "cpu":
        return burst_network_plain(tile, n)
    kl.check_cuda("burst_network_tiles", tile=tile)
    kl.word_bytes(tile, "burst_network_tiles")
    out = torch.empty_like(tile)
    wb = kl.row_word(tile, out)
    fn = kl.bind("burst_network", "medusa_burst_network", _DENSE_ARGS)
    kl.count("burst_network_tiles")
    kl.report("burst_network_tiles", tile=tile)
    kl.raise_on(fn(tile.data_ptr(), out.data_ptr(), n,
                   tile.shape[2] * tile.element_size() // wb, wb,
                   kl.stream(tile)), "burst_network_tiles")
    return out


# ----------------------------------------------------------------------------
# 4. the KV-cache layout engine (line-major → port-major)
# ----------------------------------------------------------------------------

# C signature: (descriptors: n x (in, out, B, R, C, row words) as long long,
# n, row word bytes, stream)
_TRANSPOSE_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
# leaves a launch: the kernel's descriptor table (csrc/medusa_transpose.cu
# kMaxLeaves); a longer list launches once per this many
MAX_LEAVES = 64


def medusa_transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: swap the two axes before the payload axis, into a
    contiguous tensor (``[..., R, C, W] → [..., C, R, W]``)."""
    return x.transpose(-3, -2).contiguous()


def medusa_transpose_many_plain(xs) -> list:
    """Plain version of :func:`medusa_transpose_many`: the plain swap of
    each leaf."""
    return [medusa_transpose_plain(x) for x in xs]


def check_leaves(xs, what: str) -> list:
    """``xs`` as a list of leaves ``[R, C, W]`` or ``[B, R, C, W]`` of one
    dtype on one device, each contiguous; raises otherwise."""
    xs = list(xs)
    if not xs:
        raise ValueError(f"{what}: no leaves")
    dtype, device = xs[0].dtype, xs[0].device
    for i, x in enumerate(xs):
        if x.ndim not in (3, 4):
            raise ValueError(f"{what}: leaf {i} {tuple(x.shape)} is not [R, "
                             f"C, W] or [B, R, C, W]")
        if x.dtype != dtype:
            raise TypeError(f"{what}: leaf {i} is {x.dtype}, leaf 0 "
                            f"{dtype}")
        if x.device != device:
            raise ValueError(f"{what}: leaf {i} on {x.device}, leaf 0 on "
                             f"{device}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: leaf {i} must be contiguous")
    return xs


def identity_view(x: torch.Tensor):
    """The swapped leaf as a view of ``x`` when the swap moves nothing
    (``R == 1`` or ``C == 1``: ``[B, R, C, W] → [B, C, R, W]`` is then the
    identity on memory), else None.  The view is contiguous, holds the
    plain swap's values and aliases ``x``."""
    *lead, r, c, w = x.shape
    return x.view(*lead, c, r, w) if r == 1 or c == 1 else None


def medusa_transpose_many(xs) -> list:
    """Swap the two leading axes of every leaf in ``xs`` (``[R, C, W] →
    [C, R, W]``, ``[B, R, C, W] → [B, C, R, W]``), all of them in one
    launch: the leaves share a dtype and a device, are contiguous, and may
    each have their own shape.  Above :data:`MAX_LEAVES` leaves the list
    launches once per that many, each launch counted.  A leaf whose swap
    is the identity (``R == 1`` or ``C == 1``) comes back as a view of
    itself (:func:`identity_view`) and costs no launch; every other result
    is a new contiguous tensor.  CPU leaves take the plain version.
    Raises ``ValueError`` on an empty list, leaves on other devices, a
    leaf of another rank or a non-contiguous leaf, ``TypeError`` on mixed
    dtypes or an element that is not 1, 2, 4 or 8 bytes.

    The kernel moves rows of the widest word (up to 16 bytes) that divides
    every moving leaf's row bytes and every pointer.  The wrapper's host
    time is one pass over the leaves: outputs by ``new_empty``, the
    descriptors packed into one ``array``."""
    xs = check_leaves(xs, "medusa_transpose_many")
    x0 = xs[0]
    if not x0.is_cuda:
        if x0.device.type == "cpu":
            return medusa_transpose_many_plain(xs)
        raise ValueError(f"medusa_transpose_many: leaves on {x0.device}, "
                         f"not a CUDA device")
    elt = kl.word_bytes(x0, "medusa_transpose_many")
    out, moving, leaves, wb = [], [], [], 16
    for x in xs:
        y = identity_view(x)
        if y is None:
            *lead, r, c, w = x.shape
            y = x.new_empty((*lead, c, r, w))
            row = w * elt
            if row and y.numel():
                src, dst = x.data_ptr(), y.data_ptr()
                while row % wb or src % wb or dst % wb:
                    wb //= 2
                moving.append((src, dst, lead[0] if lead else 1, r, c, row))
                leaves.append(x)
        out.append(y)
    for i in range(0, len(moving), MAX_LEAVES):
        _launch(moving[i:i + MAX_LEAVES], wb, x0.device,
                leaves[i:i + MAX_LEAVES])
    return out


def _launch(moving, wb: int, device: torch.device, leaves) -> None:
    """One launch of the layout engine over ``moving``, each ``(src, dst,
    B, R, C, row bytes)``, in row words of ``wb`` bytes; ``leaves`` are
    the tensors they describe."""
    desc = array.array("q")
    for src, dst, b, r, c, row in moving:
        desc.extend((src, dst, b, r, c, row // wb))
    fn = kl.bind("medusa_transpose", "medusa_transpose_many", _TRANSPOSE_ARGS)
    kl.count("medusa_transpose_tiles")
    kl.report("medusa_transpose_tiles", leaves=leaves)
    kl.raise_on(fn(desc.buffer_info()[0], len(moving), wb,
                   kl.raw_stream(device)), "medusa_transpose_many")


def medusa_transpose_tiles(x: torch.Tensor) -> torch.Tensor:
    """Transpose the two leading axes of ``x [R, C, W]`` → ``[C, R, W]``,
    or of every batch row of ``x [B, R, C, W]`` → ``[B, C, R, W]`` in one
    launch: :func:`medusa_transpose_many` of the one leaf, on the same
    kernel.  The kernel computes the permutation directly, so R and C may
    be any size (the reference's Pallas kernel wants multiples of a
    power-of-two tile).  Returns a contiguous tensor of ``x``'s dtype; when
    ``R == 1`` or ``C == 1`` it is a view of ``x`` and nothing launches."""
    return medusa_transpose_many((x,))[0]


# ----------------------------------------------------------------------------
# 5. the read network on group tiles
# ----------------------------------------------------------------------------

_READ_NETWORK_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_void_p]


def read_network_plain(lines: torch.Tensor, n_ports: int) -> torch.Tensor:
    """Plain version: the read network oracle, made contiguous as the
    kernel's output is (strides decide how later ops round)."""
    return read_network_oracle(lines, n_ports).contiguous()


def read_network_tiles(lines: torch.Tensor, n_ports: int) -> torch.Tensor:
    """Read network on group tiles: line stream ``lines [L, N, W]`` (L a
    multiple of N, N a power of two) → banked ``[L/N, N, N, W]`` with
    ``banked[g, y, p] = lines[g*N + p, y]``, one launch.  Returns a
    contiguous tensor of ``lines``' dtype."""
    n = n_ports
    if lines.ndim != 3:
        raise ValueError(f"bad line stream {tuple(lines.shape)} for N={n}")
    _check_line_stream(lines, n)
    log_n = _num_stages(n)
    if lines.device.type == "cpu":
        return read_network_plain(lines, n)
    kl.check_cuda("read_network_tiles", lines=lines)
    kl.word_bytes(lines, "read_network_tiles")
    l, _, w = lines.shape
    out = torch.empty((l // n, n, n, w), dtype=lines.dtype,
                      device=lines.device)
    wb = kl.row_word(lines, out)
    fn = kl.bind("read_network", "medusa_read_network", _READ_NETWORK_ARGS)
    kl.count("read_network_tiles")
    kl.report("read_network_tiles", lines=lines)
    kl.raise_on(fn(lines.data_ptr(), out.data_ptr(), l // n, log_n,
                   w * lines.element_size() // wb, wb, kl.stream(lines)),
                "read_network_tiles")
    return out
