"""The readers of the program's own ``pf.*`` spans
(portbench/harness/spans.py), on hand-made chrome traces: a span partly
outside the window is left out, a copy counts in the stage that launched
it, and a trace without the spans reads ``None``."""

import pytest

from portbench.harness import cell
from portbench.harness.trace import Trace, Traced

SPAN_METRICS = ("forecast.h2d_ms", "forecast.pc_span_ms", "forecast.bg_span_ms",
                "forecast.fg_span_ms", "forecast.fusion_span_ms", "train.h2d_ms",
                "train.optim_ms", "train.data_wait_ms")


def ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": 1, "args": args}


def span(name, ts, dur):
    return ev(name, "user_annotation", ts, dur)


def launched(name, at, ts, dur, corr, cat="kernel"):
    """A device operation and the runtime call that launched it at ``at``."""
    call = "cudaMemcpyAsync" if cat == "gpu_memcpy" else "cudaLaunchKernel"
    return [ev(call, "cuda_runtime", at, 1, correlation=corr),
            ev(name, cat, ts, dur, stream=7, correlation=corr)]


H2D = "Memcpy HtoD (Pageable -> Device)"


@pytest.fixture
def forecast():
    # window 0..300: frame one 10..110 whole (pc 10..30, bg 30..60, fg
    # 60..90, fusion 90..110), frame two 280..380 and its pc 280..320
    # partly outside
    evs = [span("pb.window", 0, 300), span("pf.forecast", 10, 100),
           span("pf.forecast.pc", 10, 20), span("pf.forecast.bg", 30, 30),
           span("pf.forecast.fg", 60, 30), span("pf.forecast.fusion", 90, 20),
           span("pf.forecast", 280, 100), span("pf.forecast.pc", 280, 40)]
    evs += launched(H2D, 5, 6, 3, 1, "gpu_memcpy")  # before the step's span
    evs += launched(H2D, 12, 13, 4, 2, "gpu_memcpy")  # pc's input
    evs += launched("reproject", 20, 20, 5, 3)
    evs += launched("Memset (Device)", 25, 26, 1, 4, "gpu_memset")
    evs += launched("conv", 35, 36, 20, 5)
    evs += launched(H2D, 62, 63, 6, 6, "gpu_memcpy")  # fg's input
    evs += launched("lstm", 70, 70, 10, 7)
    evs += launched("Memcpy DtoH (Device -> Pageable)", 100, 101, 2, 8, "gpu_memcpy")
    evs += launched("paste", 95, 96, 3, 9)
    evs += launched(H2D, 282, 283, 50, 10, "gpu_memcpy")  # frame two: left out
    evs += launched("reproject", 290, 290, 40, 11)
    return Traced(None, Trace(evs))


def test_forecast_readers(forecast):
    spec = cell.resolve("forecast_short.scene8")
    counts = {"frames": 1}
    read = {m: cell.reader(m)(forecast, counts, spec) for m in SPAN_METRICS[:5]}
    assert read == {"forecast.h2d_ms": pytest.approx((4 + 6) / 1e3),
                    "forecast.pc_span_ms": pytest.approx((5 + 1) / 1e3),
                    "forecast.bg_span_ms": pytest.approx(20 / 1e3),
                    "forecast.fg_span_ms": pytest.approx(10 / 1e3),
                    "forecast.fusion_span_ms": pytest.approx(3 / 1e3)}


def test_a_copy_counts_in_the_stage_that_launched_it(forecast):
    from portbench.harness.spans import device_ms, is_h2d

    full = forecast.full
    assert device_ms(full, "pf.forecast.pc", is_h2d) == pytest.approx(4 / 1e3)
    assert device_ms(full, "pf.forecast.fg", is_h2d) == pytest.approx(6 / 1e3)
    assert device_ms(full, "pf.forecast.bg", is_h2d) == 0.0


@pytest.fixture
def training():
    # window 100..400, opened inside the data span 90..120 and closed
    # inside the one the profiler's stop cut short (390..450): data spans
    # 200..202 and 300..304 whole; steps 130..190 and 210..290
    evs = [span("pb.window", 100, 300), span("pf.train.data", 90, 30),
           span("pf.train.step", 130, 60), span("pf.train.to_device", 130, 10),
           span("pf.train.forward", 140, 20), span("pf.train.backward", 160, 20),
           span("pf.train.optim", 180, 10), span("pf.train.data", 200, 2),
           span("pf.train.step", 210, 80), span("pf.train.to_device", 210, 10),
           span("pf.train.forward", 220, 30), span("pf.train.backward", 250, 30),
           span("pf.train.optim", 280, 10), span("pf.train.data", 300, 4),
           span("pf.train.data", 390, 60)]
    evs += launched(H2D, 131, 132, 8, 1, "gpu_memcpy")
    evs += launched("conv", 141, 142, 30, 2)
    evs += launched("sgd", 181, 185, 6, 3)
    evs += launched("Memset (Device)", 186, 192, 2, 4, "gpu_memset")
    evs += launched(H2D, 211, 212, 12, 5, "gpu_memcpy")
    evs += launched("sgd", 281, 290, 4, 6)
    return Traced(None, Trace(evs))


def test_training_readers(training):
    spec = cell.resolve("bg_train.pool8")
    counts = {"steps": 2}
    read = {m: cell.reader(m)(training, counts, spec) for m in SPAN_METRICS[5:]}
    assert read == {"train.h2d_ms": pytest.approx((8 + 12) / 2 / 1e3),
                    "train.optim_ms": pytest.approx((6 + 2 + 4) / 2 / 1e3),
                    "train.data_wait_ms": pytest.approx((2 + 4) / 2 / 1e3)}


def test_a_trace_without_the_spans_reads_none():
    bare = Trace([span("pb.window", 0, 100), span("pb.step", 0, 100)]
                 + launched(H2D, 5, 6, 3, 1, "gpu_memcpy") + launched("conv", 10, 10, 20, 2))
    both = Traced(None, bare)
    for m in SPAN_METRICS:
        name = "bg_train.pool8" if m.startswith("train.") else "forecast_short.scene8"
        assert cell.reader(m)(both, {"frames": 1, "steps": 1}, cell.resolve(name)) is None, m


def test_the_span_metrics_are_entries_of_their_cells():
    for name, prefix in (("forecast_short.scene8", "forecast."),
                         ("forecast_short.crowd32", "forecast."), ("bg_train.pool8", "train.")):
        got = {m["name"] for m in cell.resolve(name)["per_layer"]}
        assert {m for m in SPAN_METRICS if m.startswith(prefix)} <= got
