from repro_torch.configs.base import (
    LayerSpec,
    MLAConfig,
    MambaConfig,
    MoEConfig,
    ModelConfig,
    SHAPES,
    ShapeCell,
    XLSTMConfig,
    cells_for,
    get_config,
    list_configs,
    register,
)
from repro_torch.configs.reduced import reduce_config
