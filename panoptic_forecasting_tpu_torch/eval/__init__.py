from .forecast import build_forecast_step

__all__ = ["build_forecast_step"]
