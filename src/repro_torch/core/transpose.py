"""Medusa transposition unit (paper §III-A) on tensors (port of
``repro.core.transpose``).

:func:`medusa_transpose_cycle_accurate` runs the paper's N-cycle pipeline
(diagonal read, barrel rotation, transposed store) for semantics and
latency.  :func:`medusa_transpose` is the binary-exchange (Eklundh)
network: ``log2 N`` stages, each a static bit-flip block swap of both
exchange indices plus one 2-to-1 select on the stage's mux pattern — the
paper's barrel-shifter layer.  The oracles are the plain ``permute``
semantics the networks must reproduce bit for bit.  Every function is pure
word movement, so it is exact on any dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.rotation import _num_stages, barrel_rotate


# ----------------------------------------------------------------------------
# 1. The cycle-accurate pipeline (paper Fig. 4)
# ----------------------------------------------------------------------------

def medusa_transpose_cycle_accurate(input_banks: torch.Tensor,
                                    return_trace: bool = False):
    """Run the N-cycle transposition pipeline on ``input_banks [N, N,
    ...]`` (``input_banks[b, a]`` is the word at address ``a`` of bank
    ``b``).  Returns the output banks, the (bank, addr) transpose, and with
    ``return_trace`` the per-cycle ``(diagonal, rotated, partial output)``
    trace."""
    n = input_banks.shape[0]
    if input_banks.shape[1] != n:
        raise ValueError("cycle-accurate unit operates on square [N, N, ...] "
                         "tiles")
    out = torch.zeros_like(input_banks)
    banks = torch.arange(n, device=input_banks.device)
    trace = []
    for c in range(n):
        # diagonal read: bank b supplies address (b - c) mod N
        diag = input_banks[banks, (banks - c) % n]
        rot = barrel_rotate(diag, c, axis=0)
        # transposed store: bank j writes address (j + c) mod N
        out = out.index_put((banks, (banks + c) % n), rot)
        if return_trace:
            trace.append((diag, rot, out))
    return (out, trace) if return_trace else out


def transposition_latency_cycles(n_ports: int) -> int:
    """Constant latency of the unit (paper §III-E): N = W_line / W_acc."""
    return n_ports


# ----------------------------------------------------------------------------
# 2. The log-stage exchange network
# ----------------------------------------------------------------------------

def _bit_flip_both(x: torch.Tensor, axis0: int, axis1: int,
                   level: int) -> torch.Tensor:
    """``out[.., i, .., j, ..] = x[.., i^s, .., j^s, ..]`` for ``s =
    2**level``: split each exchange axis as ``(n/2s, 2, s)`` and reverse
    the two 2-sized axes — the static wiring of one barrel-shifter layer."""
    n, s = x.shape[axis0], 1 << level
    a0, a1 = (axis0, axis1) if axis0 < axis1 else (axis1, axis0)
    shp = (tuple(x.shape[:a0]) + (n // (2 * s), 2, s)
           + tuple(x.shape[a0 + 1:a1]) + (n // (2 * s), 2, s)
           + tuple(x.shape[a1 + 1:]))
    return torch.flip(x.reshape(shp), dims=(a0 + 1, a1 + 3)).reshape(x.shape)


def _swap_mask(ndim: int, n: int, axis0: int, axis1: int, level: int,
               device=None) -> torch.Tensor:
    """Stage ``level``'s select control: positions where bit ``level`` of
    the two exchange indices differ, broadcast over the payload axes."""
    i = np.arange(n)
    bit = (((i[:, None] ^ i[None, :]) >> level) & 1).astype(bool)
    shape = [1] * ndim
    shape[axis0], shape[axis1] = n, n
    return torch.from_numpy(bit.reshape(shape)).to(device)


def medusa_transpose(x: torch.Tensor, axis0: int = 0,
                     axis1: int = 1) -> torch.Tensor:
    """Transpose two equal power-of-two axes of ``x`` with the exchange
    network: ``log2 N`` stages of bit-flip block swaps and selects."""
    n = x.shape[axis0]
    if x.shape[axis1] != n:
        raise ValueError(f"medusa_transpose needs square axes, got "
                         f"{x.shape[axis0]} x {x.shape[axis1]}")
    for level in range(_num_stages(n)):
        flipped = _bit_flip_both(x, axis0, axis1, level)
        x = torch.where(_swap_mask(x.ndim, n, axis0, axis1, level, x.device),
                        flipped, x)
    return x


# ----------------------------------------------------------------------------
# 3. Line stream <-> banked port streams (the interconnect data path)
# ----------------------------------------------------------------------------

def _check_line_stream(lines: torch.Tensor, n_ports: int) -> None:
    if lines.ndim < 2:
        raise ValueError("line stream must be [num_lines, n_words, ...]")
    if lines.shape[0] % n_ports != 0:
        raise ValueError(f"num_lines={lines.shape[0]} must be a multiple of "
                         f"n_ports={n_ports}")
    if lines.shape[1] != n_ports:
        raise ValueError(f"each line carries W_line = N x W_acc: expected "
                         f"{n_ports} words, got {lines.shape[1]}")


def read_network_medusa(lines: torch.Tensor, n_ports: int) -> torch.Tensor:
    """Read network: line stream ``[L, N, W]`` → banked ``[G, N, N, W]``
    with ``banked[g, y, p] = lines[g*N + p, y]``."""
    n = n_ports
    _check_line_stream(lines, n)
    tiles = lines.reshape((lines.shape[0] // n, n, n) + tuple(lines.shape[2:]))
    return medusa_transpose(tiles, axis0=1, axis1=2)


def write_network_medusa(banked: torch.Tensor, n_ports: int) -> torch.Tensor:
    """Write network: banked ``[G, N, N, W]`` → lines ``[G*N, N, W]``."""
    n = n_ports
    if banked.shape[1] != n or banked.shape[2] != n:
        raise ValueError(f"expected [G, N, N, ...] banked buffer, "
                         f"got {tuple(banked.shape)}")
    tiles = medusa_transpose(banked, axis0=1, axis1=2)
    return tiles.reshape((tiles.shape[0] * n, n) + tuple(tiles.shape[3:]))


def read_network_oracle(lines: torch.Tensor, n_ports: int) -> torch.Tensor:
    """Plain read network (reshape + transpose)."""
    n = n_ports
    _check_line_stream(lines, n)
    tiles = lines.reshape((lines.shape[0] // n, n, n) + tuple(lines.shape[2:]))
    return tiles.transpose(1, 2)


def write_network_oracle(banked: torch.Tensor, n_ports: int) -> torch.Tensor:
    """Plain write network (transpose + reshape)."""
    n = n_ports
    tiles = banked.transpose(1, 2)
    return tiles.reshape((tiles.shape[0] * n, n) + tuple(tiles.shape[3:]))


def transpose_oracle(x: torch.Tensor, axis0: int = 0,
                     axis1: int = 1) -> torch.Tensor:
    return x.transpose(axis0, axis1)


def port_stream(banked: torch.Tensor, port: int) -> torch.Tensor:
    """Consumer view: port ``p`` reads its own deep narrow bank."""
    return banked[..., port, :] if banked.ndim >= 4 else banked[..., port]


def port_major_view(banked: torch.Tensor) -> torch.Tensor:
    """Logical ``[N_port, G, N_word, W]`` view of the banked buffer."""
    return torch.movedim(banked, 2, 0)


# ----------------------------------------------------------------------------
# 4. Rectangular layout conversion built from square tiles
# ----------------------------------------------------------------------------

def medusa_swap_minor(x: torch.Tensor, tile: int = 0) -> torch.Tensor:
    """Transpose the last two axes of ``x`` (any rectangular shape) with
    the exchange network on square power-of-two tiles: rows and columns are
    zero-padded to a multiple of the tile (default the largest power of two
    up to min(R, C, 128)), the tile grid is transposed by relabelling, and
    each tile through :func:`medusa_transpose`.  Returns a contiguous
    tensor."""
    r, c = x.shape[-2], x.shape[-1]
    if tile == 0:
        tile = max(min(1 << (max(r, 1).bit_length() - 1),
                       1 << (max(c, 1).bit_length() - 1), 128), 1)
    pr, pc = (-r) % tile, (-c) % tile
    if pr or pc:
        x = torch.nn.functional.pad(x, (0, pc, 0, pr))
    rr, cc = x.shape[-2], x.shape[-1]
    lead = tuple(x.shape[:-2])
    g = x.reshape(lead + (rr // tile, tile, cc // tile, tile))
    g = g.transpose(-3, -2)                 # [.., R, C, tile, tile]
    g = medusa_transpose(g, axis0=g.ndim - 2, axis1=g.ndim - 1)
    g = g.transpose(-4, -3)                 # the (major) tile grid
    g = g.transpose(-3, -2)
    out = g.reshape(lead + (cc, rr))
    return out[..., :c, :r].contiguous()
