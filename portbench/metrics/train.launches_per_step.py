"""train.launches_per_step: kernels launched per optimizer step in the
light traced window (memsets and copies left out)."""


def read(trace, counts, spec):
    n = sum(1 for o in trace.light.in_window() if o.cat == "kernel")
    return n / counts["steps"] if n else None
