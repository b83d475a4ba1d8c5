"""Baseline (traditional) memory interconnect — paper §II (port of
``repro.core.baseline``).

The baseline read network is a 1-to-N demux feeding N wide shallow FIFOs,
each followed by an N-to-1 width converter; the write network is its
mirror.  Its cost is ``W_line x (N-1)`` one-bit 2-to-1 muxes per direction.
The tensor form is content-flexible routing: every output word is fetched
through an explicit routing index, value-identical to the Medusa network.

* :func:`read_network_crossbar` / :func:`write_network_crossbar` — the
  demux and per-port width converters as one ``index_select`` through a
  routing index;
* :func:`width_convert_onehot` — the N-to-1 mux as a one-hot reduction;
* the BRAM cost models of §IV-C.
"""

from __future__ import annotations

import torch


def read_network_crossbar(lines: torch.Tensor, n_ports: int) -> torch.Tensor:
    """Crossbar read network: every (group, word-addr, port) output slot
    takes its source word through an explicit routing index.  ``banked[g,
    y, p] = lines[g*N + p, y]``, as the Medusa read network."""
    n = n_ports
    if lines.shape[0] % n or lines.shape[1] != n:
        raise ValueError(f"bad line stream {tuple(lines.shape)} for N={n}")
    groups = lines.shape[0] // n
    dev = lines.device
    g = torch.arange(groups, device=dev)[:, None, None]
    y = torch.arange(n, device=dev)[None, :, None]
    p = torch.arange(n, device=dev)[None, None, :]
    rest = tuple(lines.shape[2:])
    flat = lines.reshape((groups * n * n,) + rest)
    src = (g * n + p) * n + y
    return flat.index_select(0, src.reshape(-1)).reshape(
        (groups, n, n) + rest)


def write_network_crossbar(banked: torch.Tensor,
                           n_ports: int) -> torch.Tensor:
    """Crossbar write network: banked ``[G, N, N, ...]`` → lines ``[G*N, N,
    ...]`` through an explicit routing index."""
    n = n_ports
    groups = banked.shape[0]
    dev = banked.device
    line = torch.arange(groups * n, device=dev)[:, None]
    y = torch.arange(n, device=dev)[None, :]
    rest = tuple(banked.shape[3:])
    flat = banked.reshape((groups * n * n,) + rest)
    # banked[g, y, p] sits at flat[(g*n + y)*n + p]; line l = (g, p=l%n)
    src = ((line // n) * n + y) * n + line % n
    return flat.index_select(0, src.reshape(-1)).reshape(
        (groups * n, n) + rest)


def width_convert_onehot(fifo_line: torch.Tensor, select) -> torch.Tensor:
    """One step of the baseline width converter, an N-to-1 word mux:
    ``fifo_line [N, W]`` (one wide FIFO entry) and the word index
    ``select`` to present on the narrow port, as a one-hot reduction."""
    n = fifo_line.shape[0]
    onehot = (torch.arange(n, device=fifo_line.device)
              == torch.as_tensor(select, device=fifo_line.device)
              ).to(fifo_line.dtype)
    return torch.tensordot(onehot, fifo_line, dims=([0], [0]))


def fifo_bram_cost(depth_lines: int, w_line: int, bram_bits: int = 18 * 1024,
                   bram_width: int = 36) -> int:
    """BRAM-18K count of one wide shallow FIFO (§IV-C): an 18-Kbit BRAM is
    at most 36 bits wide, so a shallow ``depth x W_line`` FIFO needs
    ``ceil(W_line / 36)`` of them whatever its depth."""
    del depth_lines, bram_bits
    return -(-w_line // bram_width)


def medusa_bank_bram_cost(n_ports: int, w_acc: int, max_burst: int,
                          bram_bits: int = 18 * 1024) -> int:
    """BRAM-18K count of Medusa's deep narrow banks: N banks of
    ``(MaxBurstLen x N) x W_acc`` bits each (§IV-C)."""
    bank_bits = max_burst * n_ports * w_acc
    per_bank = -(-bank_bits // bram_bits)
    return n_ports * per_bank
