"""The barrel rotation unit on Hopper (port of ``repro.kernels.rotator``).

:func:`barrel_rotate_groups` left-rotates each group ``x[g] [N, W]`` by
``amounts[g] mod N`` positions: the CUDA kernel ``csrc/barrel_rotate.cu``
for a CUDA tensor, the plain version for a CPU tensor.  The plain version
keeps the reference kernel's structure — ``log2 N`` stages, stage ``l`` a
static roll by ``2**l`` selected by bit ``l`` of each group's amount — and
the kernel computes the composed permutation directly.  Pure word
movement: one kernel instance per word width serves every dtype.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.rotation import _num_stages
from repro_torch.kernels import launch as kl

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p]


def rotate_operands(x: torch.Tensor,
                    amounts: torch.Tensor) -> torch.Tensor:
    """Validate ``x [G, N, W]`` (N a power of two) and ``amounts [G]``;
    returns the amounts as int32 (int64 amounts wrap as the reference's
    ``astype(int32)`` does, which keeps their value mod N)."""
    if x.ndim != 3:
        raise ValueError(f"barrel rotate wants x [G, N, W], got "
                         f"{tuple(x.shape)}")
    _num_stages(x.shape[1])
    if amounts.ndim != 1 or amounts.shape[0] != x.shape[0]:
        raise ValueError(f"barrel rotate wants one amount per group: "
                         f"amounts {tuple(amounts.shape)} for x "
                         f"{tuple(x.shape)}")
    if amounts.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"rotation amounts must be int32 or int64, got "
                        f"{amounts.dtype}")
    return amounts.to(torch.int32)


def barrel_rotate_plain(x: torch.Tensor,
                        amounts: torch.Tensor) -> torch.Tensor:
    """Plain version: ``log2 N`` stages of a static roll by ``2**l`` along
    the port axis and a select on bit ``l`` of each group's amount mod N
    (``amounts & (N-1)``, the floor modulo for a power-of-two N)."""
    amounts = rotate_operands(x, amounts)
    n = x.shape[1]
    amt = (amounts & (n - 1)).view(-1, 1, 1)
    for level in range(_num_stages(n)):
        bit = ((amt >> level) & 1).bool()
        x = torch.where(bit, torch.roll(x, -(1 << level), 1), x)
    return x.contiguous()


def barrel_rotate_groups(x: torch.Tensor,
                         amounts: torch.Tensor) -> torch.Tensor:
    """Left-rotate each group ``x[g] : [N, W]`` by ``amounts[g]`` (int32
    or int64, any sign, reduced mod N) positions, N a power of two: ``out[g,
    i] = x[g, (i + amounts[g]) mod N]``.  One launch; returns a contiguous
    tensor of ``x``'s dtype."""
    amounts = rotate_operands(x, amounts)
    if x.device.type == "cpu" and amounts.device.type == "cpu":
        return barrel_rotate_plain(x, amounts)
    kl.check_cuda("barrel_rotate_groups", x=x, amounts=amounts)
    kl.word_bytes(x, "barrel_rotate_groups")
    g, n, w = x.shape
    out = torch.empty_like(x)
    wb = kl.row_word(x, out)
    fn = kl.bind("barrel_rotate", "medusa_barrel_rotate", _ARGS)
    kl.count("barrel_rotate_groups")
    kl.report("barrel_rotate_groups", x=x, amounts=amounts)
    kl.raise_on(fn(x.data_ptr(), amounts.data_ptr(), out.data_ptr(), g,
                   _num_stages(n), w * x.element_size() // wb, wb,
                   kl.stream(x)), "barrel_rotate_groups")
    return out
