"""Medusa transposition networks on tensors (port of the parts of
``repro.core.transpose`` that ``Fabric.read``/``write`` and the plain
kernel versions use).

:func:`medusa_transpose` is the binary-exchange (Eklundh) network: ``log2
N`` stages, each a static bit-flip block swap of both exchange indices plus
one 2-to-1 select on the stage's mux pattern — the paper's barrel-shifter
layer.  The oracles are the plain ``permute`` semantics the networks must
reproduce bit for bit.  Every function is pure word movement, so it is
exact on any dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def _num_stages(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"exchange network needs a power-of-two N, got {n}")
    return n.bit_length() - 1


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
