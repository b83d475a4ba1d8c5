"""DEPRECATED: use :mod:`repro_torch.fabric` instead (port of
``repro.core.interconnect``).

``Interconnect`` was the original framework-facing entry point to the
read/write data-transfer networks.  The fabric subsystem
(:class:`repro_torch.fabric.Fabric`) absorbed it — plus the burst
scheduler and the paged KV layout — so every consumer shares one
memory-movement API.  This shim keeps the old constructor working; each
method delegates to a :class:`~repro_torch.fabric.Fabric` built from the
same (n_ports, impl) pair.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Literal

import torch

Impl = Literal["medusa", "crossbar", "oracle"]


def _fabric(n_ports: int, impl: str):
    # local import: repro_torch.fabric imports repro_torch.core submodules,
    # so importing it at module scope would cycle through this package's
    # __init__.
    from repro_torch.fabric import Fabric
    return Fabric.make(n_ports=n_ports, impl=impl)


@dataclasses.dataclass(frozen=True)
class Interconnect:
    """Deprecated alias for :class:`repro_torch.fabric.Fabric` (same
    semantics)."""

    n_ports: int
    impl: Impl = "medusa"

    def __post_init__(self):
        warnings.warn(
            "repro_torch.core.interconnect.Interconnect is deprecated; use "
            "repro_torch.fabric.Fabric (Fabric.make(n_ports, impl) or "
            "Fabric.for_model(cfg))", DeprecationWarning, stacklevel=2)

    def read(self, lines: torch.Tensor) -> torch.Tensor:
        return _fabric(self.n_ports, self.impl).read(lines)

    def write(self, banked: torch.Tensor) -> torch.Tensor:
        return _fabric(self.n_ports, self.impl).write(banked)

    def swap_minor(self, x: torch.Tensor) -> torch.Tensor:
        return _fabric(self.n_ports, self.impl).swap_minor(x)

    @property
    def latency_cycles(self) -> int:
        return _fabric(self.n_ports, self.impl).latency_cycles
