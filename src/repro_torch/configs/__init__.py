from repro_torch.configs.base import (SHAPES, FabricConfig, ModelConfig,
                                      MoEConfig, PortSpec, RGLRUConfig,
                                      ShapeConfig, SSMConfig, TrainConfig)
from repro_torch.configs.registry import (ARCHS, cells, get_config,
                                          get_fabric, get_shape, get_smoke)

__all__ = ["FabricConfig", "ModelConfig", "MoEConfig", "PortSpec",
           "RGLRUConfig", "SSMConfig", "ShapeConfig", "TrainConfig", "SHAPES",
           "ARCHS", "get_config", "get_fabric", "get_smoke", "get_shape",
           "cells"]
