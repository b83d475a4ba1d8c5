from repro_torch.configs.base import (FabricConfig, ModelConfig, MoEConfig,
                                      PortSpec)
from repro_torch.configs.registry import (ARCHS, get_config, get_fabric,
                                          get_smoke)

__all__ = ["FabricConfig", "ModelConfig", "MoEConfig", "PortSpec", "ARCHS",
           "get_config", "get_fabric", "get_smoke"]
