"""``repro_torch.runtime`` — fault tolerance and gradient compression (port
of ``repro.runtime``): the deterministic :class:`FaultInjector`, the
checkpoint/restart :class:`TrainingRunner` and its
:class:`StragglerDetector`, and int8 gradient compression with error
feedback."""

from repro_torch.runtime.compression import (ErrorFeedback, compress_grads,
                                             decompress_grads,
                                             int8_dequantize, int8_quantize)
from repro_torch.runtime.fault_tolerance import (FaultInjector,
                                                 StragglerDetector,
                                                 TrainingRunner)

__all__ = ["TrainingRunner", "StragglerDetector", "FaultInjector",
           "int8_quantize", "int8_dequantize", "ErrorFeedback",
           "compress_grads", "decompress_grads"]
