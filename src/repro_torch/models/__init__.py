"""Models of the package: the straggle-risk forecast cell, and the model
zoo's configs, layers and its decoder-only and encoder-decoder assemblies
behind :class:`Model`."""
from .api import Model
from .config import LayerSlot, ModelConfig, smoke_variant
from .forecast_ssd import (
    ForecastCell,
    ForecastConfig,
    forecast_init,
    forecast_logits,
    forecast_score,
    forecast_step,
)

__all__ = [
    "ForecastCell",
    "ForecastConfig",
    "LayerSlot",
    "Model",
    "ModelConfig",
    "forecast_init",
    "forecast_logits",
    "forecast_score",
    "forecast_step",
    "smoke_variant",
]
