"""forecast.fusion_span_ms: device ms per forecast of the kernels and memsets
launched in the program's own ``pf.forecast.fusion`` span (eval/forecast.py),
in the full traced window (portbench/harness/spans.py)."""

from portbench.harness.spans import device_ms, is_kernel


def read(trace, counts, spec):
    return device_ms(trace.full, "pf.forecast.fusion", is_kernel)
