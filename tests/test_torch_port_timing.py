"""Port: the profiler timer's rule for a whole profile (``scripts/_timing``).

``device_ms`` takes a window of ``iters`` calls only when each kernel of
one call shows up there ``iters`` times its launches, and no other kernel
does; CUPTI now and then drops records. The timers themselves measure on
the GPU and raise on the CPU.
"""

import pytest
import torch

from panoptic_forecasting_tpu_torch.scripts import _timing
from panoptic_forecasting_tpu_torch.scripts._timing import whole

ONCE = {"fold": (1, 200.0), "minimum": (3, 90.0)}


@pytest.mark.parametrize("window,want", [
    ({"fold": (50, 1e4), "minimum": (150, 4500.0)}, True),
    ({"fold": (50, 1e4), "minimum": (149, 4470.0)}, False),  # a record lost
    ({"fold": (50, 1e4)}, False),  # every record of a kernel lost
    ({"fold": (50, 1e4), "minimum": (150, 4500.0), "copy": (1, 2.0)}, False),
    ({}, False),
])
def test_whole_profile(window, want):
    assert whole(ONCE, window, 50) is want


def test_whole_profile_needs_a_lone_call():
    assert not whole({}, {}, 50)  # nothing recorded of one call
    # one call's profile lost a launch: the window cannot match it
    assert not whole({"minimum": (2, 60.0)}, {"minimum": (150, 4500.0)}, 50)


@pytest.mark.parametrize("timer", [_timing.time_ms, _timing.device_ms])
def test_timers_raise_without_cuda(timer, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        timer(lambda: None)


def test_device_ms_per_call_takes_no_lone_call(monkeypatch):
    """With ``per_call`` the window alone decides: each kernel there
    ``iters * per_call`` times."""
    calls = []

    def profile(fn, n):
        calls.append(n)
        return {"stem": (n, 2.0 * n)}

    monkeypatch.setattr(_timing.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_timing.torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(_timing, "kernel_profile", profile)
    assert _timing.device_ms(lambda: None, 50, per_call=1) == 2.0 / 1e3
    assert calls == [50]
