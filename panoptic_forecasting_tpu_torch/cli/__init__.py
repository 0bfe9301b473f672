"""Command-line entry points of the port (``python -m panoptic_forecasting_tpu_torch.cli.forecast_fused``)."""
