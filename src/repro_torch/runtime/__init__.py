"""``repro_torch.runtime`` — fault tolerance for the serving engine (port
of ``repro.runtime``: the deterministic :class:`FaultInjector`)."""

from repro_torch.runtime.fault_tolerance import FaultInjector

__all__ = ["FaultInjector"]
