"""Profiling entry points of the port, run as modules:

    python -m panoptic_forecasting_tpu_torch.scripts.prof_minwin [--device cpu]
    python -m panoptic_forecasting_tpu_torch.scripts.prof_strided_load [--device cpu]

Each runs on the GPU unless given ``--device cpu``. ``_timing`` holds
their CUDA-event timer."""
