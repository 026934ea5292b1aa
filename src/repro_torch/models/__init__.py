"""Models of the package: the straggle-risk forecast cell."""
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
    "forecast_init",
    "forecast_logits",
    "forecast_score",
    "forecast_step",
]
