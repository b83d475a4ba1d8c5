"""``repro_torch.serving`` — the continuous-batching engine and its traffic
harness (port of ``repro.serving``): seeded traces, the lifecycle
recorder, the replica router, trace replay and the fault soak."""

from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.traffic import (MetricsRecorder, ReplicaRouter,
                                         TraceRecord, TrafficConfig, drive,
                                         fault_soak, generate_trace,
                                         load_trace, save_trace, trace_t_max)

__all__ = ["ServingEngine", "Request", "TrafficConfig", "TraceRecord",
           "MetricsRecorder", "ReplicaRouter", "generate_trace", "drive",
           "fault_soak", "save_trace", "load_trace", "trace_t_max"]
