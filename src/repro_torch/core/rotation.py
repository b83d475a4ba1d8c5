"""Barrel rotation unit (paper §III-B) and index-twist networks (port of
``repro.core.rotation``).

The paper's rotation unit left-rotates N words by ``c mod N`` positions
with a barrel shifter: ``log2 N`` stages, stage ``l`` rotating by ``2**l``
under bit ``l`` of the amount.  Here each stage is one static
:func:`torch.roll` plus a 2-to-1 :func:`torch.where` select.

* :func:`barrel_rotate` — the log-stage rotation unit, equal to
  ``torch.roll(x, -amount, axis)``;
* :func:`index_twist` — a row-dependent rotation (slice ``b`` rotated by
  ``b * direction``), the banks' address generators;
* the mux-count cost models of §II-B and §III-D, plain integers.

The kernel form of the rotation unit over many groups is
:func:`repro_torch.kernels.rotator.barrel_rotate_groups`.
"""

from __future__ import annotations

import torch


def _num_stages(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"barrel rotation and the exchange network need a "
                         f"power-of-two size, got {n}")
    return n.bit_length() - 1


def barrel_rotate(x: torch.Tensor, amount, axis: int = 0) -> torch.Tensor:
    """Left-rotate ``x`` along ``axis`` by ``amount`` (an int or a 0-d
    integer tensor, any sign) with ``log2 N`` barrel stages: stage ``l``
    rotates by ``2**l`` iff bit ``l`` of ``amount mod N`` is set."""
    n = x.shape[axis]
    stages = _num_stages(n)
    amount = torch.as_tensor(amount, dtype=torch.int64,
                             device=x.device) % n
    for level in range(stages):
        bit = ((amount >> level) & 1).bool()
        x = torch.where(bit, torch.roll(x, -(1 << level), axis), x)
    return x


def index_twist(x: torch.Tensor, axis: int = 0, roll_axis: int = 1,
                direction: int = -1) -> torch.Tensor:
    """Rotate slice ``b`` (taken along ``axis``) by ``direction * b`` along
    ``roll_axis``: with ``direction=-1`` (a left twist) ``out[b, k] = x[b,
    (k + b) % N]`` for a 2-D input; ``direction=+1`` is the inverse.
    ``log2 N`` stages of a static roll and a select on bit ``l`` of the
    slice index."""
    n = x.shape[axis]
    stages = _num_stages(n)
    shape = [1] * x.ndim
    shape[axis] = n
    idx = torch.arange(n, device=x.device).view(shape)
    for level in range(stages):
        take = ((idx >> level) & 1).bool()
        x = torch.where(take, torch.roll(x, direction * (1 << level),
                                         roll_axis), x)
    return x


# ----------------------------------------------------------------------------
# Logic-complexity cost models (paper §II-B and §III-D)
# ----------------------------------------------------------------------------

def baseline_mux_count(w_line: int, num_ports: int) -> int:
    """2-to-1 one-bit muxes of the baseline data-transfer network: N width
    converters, each an N-to-1 mux of width ``W_line / N`` →
    ``W_line x (N-1)``."""
    return w_line * (num_ports - 1)


def medusa_mux_count(w_line: int, num_ports: int) -> int:
    """2-to-1 one-bit muxes of the Medusa rotation unit: ``log2 N`` layers
    of ``W_line`` one-bit muxes each."""
    return w_line * _num_stages(num_ports)


def mux_reduction(w_line: int, num_ports: int) -> float:
    """Baseline/Medusa mux ratio — the paper's complexity win."""
    return (baseline_mux_count(w_line, num_ports)
            / medusa_mux_count(w_line, num_ports))


def rotation_depth(num_ports: int) -> int:
    """Levels of 2-to-1 muxes through the rotation unit: ``log2 N``."""
    return _num_stages(num_ports)
