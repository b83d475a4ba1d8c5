from repro_torch.configs.base import (FabricConfig, ModelConfig, MoEConfig,
                                      PortSpec, RGLRUConfig, SSMConfig)
from repro_torch.configs.registry import (ARCHS, get_config, get_fabric,
                                          get_smoke)

__all__ = ["FabricConfig", "ModelConfig", "MoEConfig", "PortSpec",
           "RGLRUConfig", "SSMConfig", "ARCHS",
           "get_config", "get_fabric", "get_smoke"]
