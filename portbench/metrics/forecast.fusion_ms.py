"""forecast.fusion_ms: device ms per forecast of the step's fusion stage
in the full traced window (portbench/harness/stages.py says which launches
belong to it)."""

from portbench.harness.stages import split_us


def read(trace, counts, spec):
    us = split_us(trace.full)["fusion"]
    return us / 1e3 / counts["frames"] if us > 0 else None
