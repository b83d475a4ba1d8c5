"""Logic-complexity and resource models of the paper's accounting (port of
``repro.core.analysis``).

The analytic reproductions of the paper's §II-B, §III-D and §IV numbers —
mux counts, BRAM counts and the resource table's ratios — in plain integer
arithmetic over :mod:`repro_torch.core.rotation`'s and
:mod:`repro_torch.core.baseline`'s cost models.  Nothing here touches a
tensor.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.baseline import fifo_bram_cost, medusa_bank_bram_cost
from repro_torch.core.rotation import (baseline_mux_count, medusa_mux_count,
                                       mux_reduction, rotation_depth)


@dataclasses.dataclass(frozen=True)
class InterconnectConfig:
    """One design point of the interconnect (paper §IV-C uses 512/16/32/32)."""

    w_line: int = 512             # DRAM controller interface width, bits
    w_acc: int = 16               # accelerator port width, bits
    n_read_ports: int = 32
    n_write_ports: int = 32
    max_burst: int = 32           # lines per burst buffered per port

    @property
    def n(self) -> int:
        n = self.w_line // self.w_acc
        assert n == self.n_read_ports, "ports must evenly split the line"
        return n

    @property
    def latency_cycles(self) -> int:
        """Constant latency overhead (§III-E): W_line / W_acc cycles."""
        return self.w_line // self.w_acc


@dataclasses.dataclass(frozen=True)
class ResourceEstimate:
    mux_bits_read: int
    mux_bits_write: int
    bram_read: int
    bram_write: int
    logic_depth: int

    @property
    def mux_bits_total(self) -> int:
        return self.mux_bits_read + self.mux_bits_write


def baseline_resources(cfg: InterconnectConfig) -> ResourceEstimate:
    """Baseline (§II): W_line x (N-1) muxes/direction; FIFOs in LUTRAM (0
    BRAM, as in Table II) — or ``fifo_bram_cost`` x N each if BRAM-mapped."""
    return ResourceEstimate(
        mux_bits_read=baseline_mux_count(cfg.w_line, cfg.n_read_ports),
        mux_bits_write=baseline_mux_count(cfg.w_line, cfg.n_write_ports),
        bram_read=0,
        bram_write=0,
        logic_depth=int(math.ceil(math.log2(max(cfg.n_read_ports, 2)))),
    )


def baseline_bram_mapped(cfg: InterconnectConfig) -> int:
    """If the baseline's wide shallow FIFOs were BRAM-mapped: 15 BRAMs per
    32x512b FIFO → 960 for 64 ports (§IV-C) — the poor trade-off the paper
    calls out."""
    per_fifo = fifo_bram_cost(cfg.max_burst, cfg.w_line)
    return per_fifo * (cfg.n_read_ports + cfg.n_write_ports)


def medusa_resources(cfg: InterconnectConfig) -> ResourceEstimate:
    """Medusa (§III-D): W_line x log2(N) rotation muxes/direction; deep-narrow
    banks map to 1 BRAM each (32/direction at the paper's design point)."""
    return ResourceEstimate(
        mux_bits_read=medusa_mux_count(cfg.w_line, cfg.n_read_ports),
        mux_bits_write=medusa_mux_count(cfg.w_line, cfg.n_write_ports),
        bram_read=medusa_bank_bram_cost(cfg.n_read_ports, cfg.w_acc,
                                        cfg.max_burst),
        bram_write=medusa_bank_bram_cost(cfg.n_write_ports, cfg.w_acc,
                                         cfg.max_burst),
        logic_depth=rotation_depth(cfg.n_read_ports),
    )


def paper_design_point() -> InterconnectConfig:
    """The §IV-C design point: 512-bit DDR3 interface, 32r+32w 16-bit ports."""
    return InterconnectConfig()


def complexity_summary(cfg: InterconnectConfig) -> dict:
    base = baseline_resources(cfg)
    med = medusa_resources(cfg)
    return {
        "w_line": cfg.w_line,
        "n_ports": cfg.n_read_ports,
        "baseline_mux_bits": base.mux_bits_total,
        "medusa_mux_bits": med.mux_bits_total,
        "mux_reduction": mux_reduction(cfg.w_line, cfg.n_read_ports),
        "baseline_bram_if_mapped": baseline_bram_mapped(cfg),
        "medusa_bram": med.bram_read + med.bram_write,
        "latency_overhead_cycles": cfg.latency_cycles,
        "baseline_logic_depth": base.logic_depth,
        "medusa_logic_depth": med.logic_depth,
    }


# Paper-reported figures used as validation targets by the benchmarks.
PAPER_TABLE2 = {
    "baseline": {"read_lut": 18168, "read_ff": 19210, "write_lut": 26810,
                 "write_ff": 35451, "read_bram": 0, "write_bram": 0},
    "medusa": {"read_lut": 4733, "read_ff": 4759, "write_lut": 4777,
               "write_ff": 4325, "read_bram": 32, "write_bram": 32},
    "claimed_lut_reduction": 4.73,
    "claimed_ff_reduction": 6.02,
    "claimed_freq_gain": 1.8,
}


def paper_reported_reductions() -> tuple[float, float]:
    t = PAPER_TABLE2
    lut = ((t["baseline"]["read_lut"] + t["baseline"]["write_lut"])
           / (t["medusa"]["read_lut"] + t["medusa"]["write_lut"]))
    ff = ((t["baseline"]["read_ff"] + t["baseline"]["write_ff"])
          / (t["medusa"]["read_ff"] + t["medusa"]["write_ff"]))
    return lut, ff
