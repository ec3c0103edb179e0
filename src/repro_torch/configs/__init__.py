from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    PHNSWConfig,
    RetrievalConfig,
    ShapeConfig,
    SHAPES,
    smoke_config,
)
from repro_torch.configs.registry import (
    ARCH_IDS,
    all_cells,
    cell_supported,
    get_config,
    get_shape,
    get_smoke_config,
)

__all__ = [
    "ModelConfig", "MoEConfig", "PHNSWConfig", "RetrievalConfig",
    "ShapeConfig", "SHAPES", "smoke_config", "ARCH_IDS", "all_cells",
    "cell_supported",
    "get_config", "get_shape", "get_smoke_config",
]
