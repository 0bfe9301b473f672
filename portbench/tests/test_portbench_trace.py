"""Reading a chrome trace: launch attribution, busy and idle time, the
light window between markers, the forecast's stage split and the metric
readers, on hand-made traces."""

import pytest

from portbench.harness import cell
from portbench.harness.stages import split_us
from portbench.harness.trace import Trace, Traced


def ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": 1, "args": args}


def launch(ts, corr):
    return ev("cudaLaunchKernel", "cuda_runtime", ts, 1, correlation=corr)


def kernel(name, ts, dur, corr=None, cat="kernel"):
    args = {"stream": 7}
    if corr is not None:
        args["correlation"] = corr
    return ev(name, cat, ts, dur, **args)


@pytest.fixture
def trace():
    # one step 0..100 µs: pc launches at 5 (and a library kernel with no
    # launch record), bg range 20..50, fg range 55..80, fusion at 85
    return Trace([
        ev("pb.window", "user_annotation", 0, 100), ev("pb.step", "user_annotation", 0, 100),
        ev("pb.bg_model", "user_annotation", 20, 30), ev("pb.fg_model", "user_annotation", 55, 25),
        launch(5, 1), kernel("reproject", 10, 4, 1), kernel("fold_place(int const*)", 14, 2),
        kernel("h2d", 8, 2, cat="gpu_memcpy"),
        launch(25, 2), kernel("stem_kernel<float>", 26, 3, 2),
        launch(30, 3), kernel("conv", 30, 12, 3),
        launch(60, 4), kernel("lstm", 60, 10, 4),
        launch(85, 5), kernel("paste", 90, 5, 5),
    ])


def test_busy_and_ops(trace):
    # device busy: [8,16) [26,29) [30,42) [60,70) [90,95)
    assert trace.busy_us() == pytest.approx(8 + 3 + 12 + 10 + 5)
    assert trace.ops[2].launch == 5  # fold_place takes the launch before it
    names = dict(trace.device_ops())
    assert names["conv"] == pytest.approx(12e-6)
    gaps = dict(trace.idle_gaps())
    assert sum(gaps.values()) == pytest.approx((100 - 38) * 1e-6)


def test_stage_split(trace):
    us = split_us(trace)
    assert us == {"pc": pytest.approx(6), "bg": pytest.approx(15), "fg": pytest.approx(10),
                  "fusion": pytest.approx(5)}


@pytest.fixture
def light():
    # the device alone: a warm-up kernel before the first marker (left
    # out), the window from the first marker's end (10) to the last's
    # start (90), kernels [20,40) [30,50) [60,70), a copy [80,85)
    return Trace([
        kernel("warm", 0, 5), kernel("spin_kernel(long)", 8, 2),
        kernel("conv", 20, 20), kernel("bn", 30, 20), kernel("relu", 60, 10),
        kernel("h2d", 80, 5, cat="gpu_memcpy"), kernel("spin_kernel(long)", 90, 2),
    ])


def test_light_window_between_markers(light):
    assert light.window() == (10, 90) and light.whole()
    assert [o.name for o in light.in_window()] == ["conv", "bn", "relu", "h2d"]
    assert light.busy_us() == pytest.approx(30 + 10 + 5)
    assert all("spin_kernel" not in n for n, _ in light.device_ops())


def test_readers(trace, light):
    both = Traced(light, trace)
    spec = cell.resolve("forecast_short.scene8")
    counts = {"frames": 1, "host_s": 90e-6, "flops": 67e12 * 45e-6}
    assert cell.reader("forecast.mfu")(both, counts, spec) == pytest.approx(50.0)
    assert cell.reader("forecast.idle_share")(both, counts, spec) == pytest.approx(50.0)
    assert cell.reader("forecast.bg_ms")(both, counts, spec) == pytest.approx(0.015)
    k1 = cell.reader("forecast.k1_roofline")(both, counts, spec)
    assert k1 == pytest.approx(100 * 3 * 1024 * 2048 * 12 / 3.35e12 / 2e-6)
    spec_t = cell.resolve("bg_train.pool8")
    assert cell.reader("train.launches_per_step")(both, {"steps": 2}, spec_t) == 1.5
    assert cell.reader("train.mfu")(both, {"steps": 2, "host_s": 40e-6, "flops": 67e12 * 40e-6},
                                    spec_t) == pytest.approx(100.0)


def test_no_reading_is_left_out(light):
    empty = Traced(light, Trace([ev("pb.window", "user_annotation", 0, 10)]))
    spec = cell.resolve("forecast_short.scene8")
    for m in ("forecast.k1_roofline", "forecast.k2_roofline", "forecast.pc_ms"):
        assert cell.reader(m)(empty, {"frames": 1}, spec) is None


def test_light_window_that_lost_a_marker_is_not_whole():
    lost = Trace([kernel("spin_kernel(long)", 8, 2), kernel("conv", 20, 20)])
    assert not lost.whole()
