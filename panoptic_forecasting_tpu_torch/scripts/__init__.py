"""Profiling entry points of the port, run as modules:

    python -m panoptic_forecasting_tpu_torch.scripts.prof_minwin [--device cpu]
    python -m panoptic_forecasting_tpu_torch.scripts.prof_strided_load [--device cpu]
    python -m panoptic_forecasting_tpu_torch.scripts.prof_stem

The first two run on the GPU unless given ``--device cpu``; ``prof_stem``
(K2 beside ablated builds of it) runs on the GPU only. ``_timing`` holds
their CUDA-event and profiler timers."""
