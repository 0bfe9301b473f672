"""The check that decides ``correct``, driven through a whole run at the
tiny size with the timed path broken underneath: each fault the cell can
have, and the control (the reference in TF32 in the program's place),
must come out not correct under the cell's own limits."""

import time

import pytest
import torch

from portbench.harness import bg_train, cell, check, forecast
from portbench.harness.faults import DATA_FAULTS
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 99


def run(name, fault=None, **limits):
    s = tiny.spec(name, **limits)
    return cell.execute(name, SEED, 0.3, False, CPU, time.perf_counter(), fault=fault, spec=s)


def test_sound_forecast_is_correct():
    assert run("forecast_short.scene8")["correct"]


@pytest.mark.parametrize("name,grad,change", [("bg_train.pool8", 1e-4, 0.2),
                                              ("bg_train.loader8", 2e-2, 0.3)])
def test_sound_training_is_correct_at_tiny_limits(name, grad, change):
    """At 128x128 and batch 2 the deepest BatchNorms see 8 values a
    channel, and the later steps' rounding grows past the full-size
    limits: a sound tiny run is held to limits of its own size (over the
    files, mostly padding at 64x128, a depth statistic's last bit moves
    the first gradient by 7e-4)."""
    assert run(name, loss1_rel=1e-5, grad_rel=grad, change_rel=change)["correct"]


@pytest.mark.parametrize("name,fault", [("forecast_short.scene8", f) for f in forecast.FAULTS]
                         + [("bg_train.pool8", f) for f in bg_train.FAULTS]
                         + [("bg_train.loader8", f) for f in DATA_FAULTS])
def test_fault_is_not_correct(name, fault):
    runner = cell.runner(tiny.spec(name)["config"]["kind"])
    line = run(name, dict(runner.FAULTS, **DATA_FAULTS)[fault])
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", ["forecast_short.scene8", "bg_train.pool8",
                                  "bg_train.loader8"])
def test_control_is_not_correct(name):
    s = tiny.spec(name)
    numbers = cell.runner(s["config"]["kind"]).control(s, SEED, CPU, emulate=True)
    ok, rows = check.judge(numbers, check.limits(name))
    assert not ok, rows
