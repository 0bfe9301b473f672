"""train.data_wait_ms: host ms per fetch of the program's ``pf.train.data``
spans (``train()`` waiting on its loader's ``next()``, train/loop.py), on
the profiler's clock in the full traced window
(portbench/harness/spans.py)."""

from portbench.harness.spans import host_ms


def read(trace, counts, spec):
    return host_ms(trace.full, "pf.train.data")
