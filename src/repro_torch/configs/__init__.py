"""Architecture configs (exact public numbers); the port carries
``smollm-135m``."""

from .base import (LayerSpec, MLAConfig, ModelConfig, MoEConfig,
                   PORTED_ARCHS, Segment, SSMConfig, load_config, reduced)

__all__ = ["LayerSpec", "MLAConfig", "ModelConfig", "MoEConfig",
           "PORTED_ARCHS", "Segment", "SSMConfig", "load_config", "reduced"]
