"""Burst transfer support (paper §III-C): head/tail pointers, shared deep
buffer, interference-free per-port progress (port of
``repro.core.burst``).

A cycle-level functional simulator of the Medusa read path under bursty
arrivals.  It exists to *validate the paper's claims*, not to run in the
serving data path:

* the input buffer holds ``MaxBurstLen x N`` lines (N banks, deep and
  narrow);
* per-port head/tail pointers track occupancy; only lines at the head
  pointers take part in the rotation;
* a port joins the transposition at the current global phase without
  waiting for other ports (§III-F: no inter-port interference);
* the latency from a line's arrival to its availability at the port is the
  constant ``N`` cycles of §III-E (plus its queueing delay behind earlier
  lines of the same port — a FIFO property shared with the baseline).

The state is float32 and int32 tensors on ``device`` (resolved like every
entry point: ``cuda`` unless the caller asks for the CPU); each cycle moves
words with :func:`repro_torch.core.rotation.barrel_rotate`, with plain
Python control flow around it (a test vehicle, driven for N <= 16).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.rotation import barrel_rotate


@dataclasses.dataclass
class MedusaReadSim:
    """State of the read-side transposition unit with burst buffering."""

    n_ports: int
    depth: int                       # lines buffered per port (>= MaxBurstLen)
    word_width: int = 1
    device: Optional[object] = None

    def __post_init__(self):
        n, d, w = self.n_ports, self.depth, self.word_width
        self.device = dev = resolve_device(self.device)
        i32 = dict(dtype=torch.int32, device=dev)
        # input banks: [bank=word-idx y, port-region x, slot, W]
        self.in_buf = torch.zeros((n, n, d, w), dtype=torch.float32,
                                  device=dev)
        self.in_valid = torch.zeros((n, d), dtype=torch.bool, device=dev)
        self.head = torch.zeros((n,), **i32)
        self.tail = torch.zeros((n,), **i32)
        # progress of the in-flight transposition of each port's head line:
        # number of words already moved (0..N); starts mid-phase when joining
        self.words_done = torch.zeros((n,), **i32)
        # output banks: [port, slot, word-idx, W] + completion events
        self.out_buf = torch.zeros((n, d, n, w), dtype=torch.float32,
                                   device=dev)
        self.out_time = torch.full((n, d), -1, **i32)    # cycle completed
        self.cycle = 0
        self.arrival_time = torch.full((n, d), -1, **i32)

    # -- DRAM side -----------------------------------------------------------
    def push_line(self, port: int, line) -> None:
        """A full W_line line for ``port`` arrives from the memory controller
        (one line per cycle max — call at most once per :meth:`step`)."""
        n, d = self.n_ports, self.depth
        line = torch.as_tensor(line).to(device=self.device,
                                        dtype=torch.float32)
        line = line.reshape(n, self.word_width)
        slot = int(self.tail[port]) % d
        if bool(self.in_valid[port, slot]):
            raise RuntimeError(f"port {port} buffer overflow (backpressure)")
        # word y of the line goes to bank y, into this port's region
        self.in_buf[:, port, slot] = line
        self.in_valid[port, slot] = True
        self.tail[port] += 1
        self.arrival_time[port, slot] = self.cycle

    # -- one clock cycle ------------------------------------------------------
    def step(self) -> None:
        """Advance one cycle of the pipeline (paper Fig. 4 + §III-C/F).

        Bank ``b`` serves the port ``p(b) = (b - c) mod N`` — each active
        port contributes exactly one word per cycle (its phase word
        ``y = (c + p) mod N``), one word per bank, conflict-free.  The barrel
        rotator left-rotates the bank-ordered diagonal by ``c``; output bank
        ``j`` then stores at address ``(j + c) mod N``.  Ports with no valid
        head line leave their diagonal slot idle (§III-F: a port joins at the
        current phase without disturbing the others).
        """
        n, d = self.n_ports, self.depth
        c = self.cycle
        ports = torch.arange(n, device=self.device)
        # diagonal read, bank-indexed: bank b reads its region for port (b-c)%N
        p_of_b = (ports - c) % n
        slot_b = (self.head[p_of_b] % d).long()
        active_b = self.in_valid[p_of_b, slot_b]
        diag = self.in_buf[ports, p_of_b, slot_b]               # [n, W]
        # rotation unit (the only data movement): rot[j] = word(x=j, y=(j+c)%N)
        rot = barrel_rotate(torch.where(active_b[:, None], diag, 0.0),
                            c % n, axis=0)
        active = barrel_rotate(active_b, c % n, axis=0)
        # transposed store: output bank j, address (j + c) mod N, head slot
        addr = (ports + c) % n
        dest_slot = (self.head % d).long()
        cur = self.out_buf[ports, dest_slot, addr]
        self.out_buf[ports, dest_slot, addr] = torch.where(active[:, None],
                                                           rot, cur)
        self.words_done = self.words_done + active.to(torch.int32)
        finished = self.words_done >= n
        self.out_time = torch.where(
            (finished & active)[:, None]
            & (torch.arange(d, device=self.device)[None, :]
               == dest_slot[:, None]),
            c, self.out_time)
        # retire finished head lines; pointers advance per port independently
        self.in_valid[ports, dest_slot] = torch.where(
            finished, False, self.in_valid[ports, dest_slot])
        self.head = torch.where(finished, self.head + 1, self.head)
        self.words_done = torch.where(finished, 0, self.words_done)
        self.cycle += 1

    def run(self, cycles: int) -> None:
        for _ in range(cycles):
            self.step()

    # -- accelerator side ----------------------------------------------------
    def pop_line(self, port: int, slot: int) -> torch.Tensor:
        """Port-side read of a completed line (deep-narrow output bank): a
        copy, so later cycles do not change it."""
        return self.out_buf[port, slot % self.depth].clone()

    def completion_latency(self, port: int, slot: int) -> int:
        """Cycles from arrival to full availability (paper §III-E: <= ~N)."""
        return int(self.out_time[port, slot]
                   - self.arrival_time[port, slot]) + 1
