"""The program's own spans in the full traced window.

The port opens ``pf.*`` ranges at its own stages while a profiler records
(``panoptic_forecasting_tpu_torch/core/tracing.py``): ``pf.forecast`` and
its ``.pc``/``.bg``/``.fg``/``.fusion`` stages, ``pf.train.data`` around
the loader's ``next()``, ``pf.train.step`` and its ``.to_device``,
``.forward``, ``.backward`` and ``.optim``. They are ``user_annotation``
events of the trace's host. Only a span lying wholly inside the window
counts (the ``pf.train.data`` span in which the harness opens its own
``pb.window`` is left out, and so is one the profiler's stop cut short);
a device operation belongs to a span when it was launched in it. A
trace of a program without these spans has none: each reading is then
``None``.
"""

from __future__ import annotations

import bisect
from typing import Callable, List, Optional, Tuple


def is_h2d(o) -> bool:
    """A host-to-device copy (the profiler's ``Memcpy HtoD (... -> Device)``)."""
    return o.cat == "gpu_memcpy" and "HtoD" in o.name


def is_kernel(o) -> bool:
    """A kernel or a memset."""
    return o.cat in ("kernel", "gpu_memset")


def spans(trace, name: str) -> List[Tuple[float, float]]:
    """The ``name`` ranges wholly inside the window, in order (µs)."""
    a, b = trace.window()
    return sorted((s, e) for s, e, n, _ in trace.host if n == name and a <= s <= e <= b)


def device_ms(trace, name: str, keep: Callable) -> Optional[float]:
    """Device ms a span of the operations ``keep`` admits that were
    launched in a ``name`` span; ``None`` where there is no such span."""
    got = spans(trace, name)
    if not got:
        return None
    starts = [s for s, _ in got]
    us = 0.0
    for o in trace.ops:
        i = bisect.bisect_right(starts, o.launch) - 1
        if i >= 0 and o.launch <= got[i][1] and keep(o):
            us += o.end - o.start
    return us / 1e3 / len(got)


def host_ms(trace, name: str) -> Optional[float]:
    """Host ms a ``name`` span, on average; ``None`` where there is none."""
    got = spans(trace, name)
    return sum(e - s for s, e in got) / 1e3 / len(got) if got else None
