"""Medusa core: the transposition-based memory interconnect (the paper's
contribution; port of ``repro.core``): the rotation unit, the exchange
network and its oracles, the crossbar baseline, the burst simulator,
the resource model and the deprecated ``Interconnect`` shim."""

from repro_torch.core.rotation import (barrel_rotate, index_twist,
                                       baseline_mux_count, medusa_mux_count,
                                       mux_reduction, rotation_depth)
from repro_torch.core.transpose import (medusa_transpose,
                                        medusa_transpose_cycle_accurate,
                                        medusa_swap_minor,
                                        read_network_medusa,
                                        write_network_medusa,
                                        read_network_oracle,
                                        write_network_oracle, port_stream,
                                        port_major_view,
                                        transposition_latency_cycles)
from repro_torch.core.baseline import (read_network_crossbar,
                                       write_network_crossbar,
                                       width_convert_onehot)
from repro_torch.core.interconnect import Interconnect
from repro_torch.core.analysis import (InterconnectConfig, baseline_resources,
                                       medusa_resources, complexity_summary,
                                       paper_design_point, PAPER_TABLE2,
                                       paper_reported_reductions)
from repro_torch.core.burst import MedusaReadSim

__all__ = [
    "barrel_rotate", "index_twist", "baseline_mux_count", "medusa_mux_count",
    "mux_reduction", "rotation_depth", "medusa_transpose",
    "medusa_transpose_cycle_accurate", "medusa_swap_minor",
    "read_network_medusa", "write_network_medusa", "read_network_oracle",
    "write_network_oracle", "port_stream", "port_major_view",
    "transposition_latency_cycles", "read_network_crossbar",
    "write_network_crossbar", "width_convert_onehot", "Interconnect",
    "InterconnectConfig", "baseline_resources", "medusa_resources",
    "complexity_summary", "paper_design_point", "PAPER_TABLE2",
    "paper_reported_reductions", "MedusaReadSim",
]
