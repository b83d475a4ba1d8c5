"""Bytes a launch of one of the port's movement kernels needs, frozen here.

The arithmetic is that of ``repro_torch.kernels.launch.kernel_cost`` as it
stood when the benchmark was defined: each input read once and each output
written once.  It takes plain numbers (element counts and widths), so a
later change to the program's own cost function cannot move the yardstick.

- kernel 1, the fused gather (``gather_burst_network_tiles``): the live
  frames it reads, its index operand, and every output frame it writes
  (sentinel frames are written as zeros);
- kernel 2, the fused scatter (``scatter_burst_network_tiles``): each live
  frame read and written once, and its index operand (sentinel frames are
  neither read nor written).
"""

from __future__ import annotations

GATHER = "gather_burst_network_tiles"
SCATTER = "scatter_burst_network_tiles"


def gather_bytes(live: int, frame_bytes: int, idx_bytes: int,
                 out_bytes: int) -> int:
    """Kernel 1: ``live`` frames of ``frame_bytes`` read, the index read,
    the whole output written."""
    return live * frame_bytes + idx_bytes + out_bytes


def scatter_bytes(live: int, frame_bytes: int, idx_bytes: int) -> int:
    """Kernel 2: ``live`` frames read from the banked input and written
    into the pool, the index read."""
    return 2 * live * frame_bytes + idx_bytes


def launch_bytes(name: str, live: int, frame_bytes: int, idx_bytes: int,
                 out_bytes: int = 0) -> int:
    """Bytes of one launch of kernel ``name`` (:data:`GATHER` or
    :data:`SCATTER`)."""
    if name == GATHER:
        return gather_bytes(live, frame_bytes, idx_bytes, out_bytes)
    if name == SCATTER:
        return scatter_bytes(live, frame_bytes, idx_bytes)
    raise KeyError(f"no frozen cost for kernel {name!r}")
