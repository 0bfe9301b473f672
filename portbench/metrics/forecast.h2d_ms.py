"""forecast.h2d_ms: device ms per forecast of the host-to-device copies
launched in the program's ``pf.forecast`` span (the step's conversions of
its host inputs, eval/forecast.py ``tensor()``), in the full traced
window (portbench/harness/spans.py)."""

from portbench.harness.spans import device_ms, is_h2d


def read(trace, counts, spec):
    return device_ms(trace.full, "pf.forecast", is_h2d)
