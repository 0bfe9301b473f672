"""train.h2d_ms: device ms per step of the host-to-device copies launched
in the program's ``pf.train.step`` span (the batch's transfer,
train/loop.py ``to_device``), in the full traced window
(portbench/harness/spans.py)."""

from portbench.harness.spans import device_ms, is_h2d


def read(trace, counts, spec):
    return device_ms(trace.full, "pf.train.step", is_h2d)
