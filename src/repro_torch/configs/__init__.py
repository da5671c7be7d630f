from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeCell, SHAPES, SHAPES_BY_NAME, cell_applicable,
    DENSE, MOE, HYBRID, SSM, ENCDEC, VLM,
)
from repro_torch.configs.registry import ARCHS, get_config, list_archs  # noqa: F401
