"""Architecture configs (exact public numbers) + shape registry."""

from .base import (ARCH_IDS, SHAPES, InputShape, LayerSpec, MLAConfig,
                   ModelConfig, MoEConfig, Segment, SSMConfig,
                   cell_is_applicable, load_config, reduced)

__all__ = ["ARCH_IDS", "SHAPES", "InputShape", "LayerSpec", "MLAConfig",
           "ModelConfig", "MoEConfig", "Segment", "SSMConfig",
           "cell_is_applicable", "load_config", "reduced"]
