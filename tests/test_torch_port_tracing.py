"""The port's program spans (``core/tracing.py``): ``pf.forecast`` and its
four stages in ``eval/forecast.py``, ``pf.train.data`` and ``pf.train.step``
with its phases in ``train/loop.py``, read back from a CPU
``torch.profiler``'s chrome trace.

Sizes: the forecast at 64x128 with 3 inputs, as in
tests/test_torch_port_forecast.py, and a small fg model; training on the
port's odometry fixture, as in tests/test_torch_port_train.py. Outputs,
losses and weights must be bit-equal with a profiler on and off.
"""

import json
import os

import numpy as np
import pytest
import torch

from panoptic_forecasting_tpu_torch.core import build_dataset, build_model
from panoptic_forecasting_tpu_torch.core import tracing
from panoptic_forecasting_tpu_torch.data import synthetic
from panoptic_forecasting_tpu_torch.eval.forecast import build_forecast_step
from panoptic_forecasting_tpu_torch.geometry import rdf_T_flu, unicycle_now_T_prev
from panoptic_forecasting_tpu_torch.models.bg import BGModel
from panoptic_forecasting_tpu_torch.models.fg import FGModel
from panoptic_forecasting_tpu_torch.train.loop import train

torch.set_num_threads(2)

H, W, T, OUT_T, N = 64, 128, 3, 3, 4
STAGES = ["pf.forecast.pc", "pf.forecast.bg", "pf.forecast.fg", "pf.forecast.fusion"]
PHASES = ["pf.train.to_device", "pf.train.forward", "pf.train.backward", "pf.train.optim"]


def profiler():
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    return prof


def spans(prof, path):
    """The ``pf.*`` ranges of a stopped profiler: (name, start, end) in
    start order, the outer of two equal starts first."""
    prof.export_chrome_trace(str(path))
    return read_spans(path)


def read_spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("cat") == "user_annotation" and e["name"].startswith("pf.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


# ---- the helper ------------------------------------------------------------

def test_span_builds_nothing_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with tracing.span("x"):
        pass
    assert list(tracing.spanned(range(3), "y")) == [0, 1, 2]


def test_spanned_closes_each_span_before_its_item(tmp_path):
    prof = profiler()
    seen = []
    for item in tracing.spanned(iter("abc"), "fetch"):
        with torch.profiler.record_function(f"pf.body.{item}"):
            seen.append(item)
    prof.stop()
    assert seen == ["a", "b", "c"]
    got = spans(prof, tmp_path / "t.json")
    # three fetches and the one that ends the iterator, each before its body
    assert [n for n, *_ in got] == ["pf.fetch", "pf.body.a", "pf.fetch", "pf.body.b",
                                    "pf.fetch", "pf.body.c", "pf.fetch"]
    assert all(a[2] <= b[1] for a, b in zip(got, got[1:]))
    assert list(tracing.spanned([], "fetch")) == []


# ---- the forecast step ------------------------------------------------------

def forecast_case():
    torch.manual_seed(0)
    bg = BGModel({"model": {"num_inputs": T, "convert2onehot": True, "use_depth_inps": True},
                  "data": {"num_classes": 11}}, device="cpu").maybe_fold()
    fg = FGModel({"model": {"rnn_hidden": 16, "instance_feat_hidden": 8,
                            "traj_feat_channels": 4, "mask_feat_channels": 8,
                            "mask_feat_hw": 7, "mask_head": {"conv_dim": 8},
                            "use_depth_inp": True, "use_odometry": True,
                            "use_depth_sorting": True}}, device="cpu")
    rng = np.random.RandomState(0)
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    E = (np.array([[1, 0, 0, 0.3], [0, 1, 0, 0.0], [0, 0, 1, 1.1], [0, 0, 0, 1]],
                  np.float32) @ rdf_T_flu()).astype(np.float32)
    Ts = unicycle_now_T_prev(np.array([3.0, 2.0, 1.0], np.float32),
                             np.array([0.02, 0.0, -0.01], np.float32), 0.35).numpy()
    pc_in = {"seg": rng.randint(0, 19, (1, T, H, W)).astype(np.int32),
             "depth": (rng.rand(1, T, H, W) * 40 + 2).astype(np.float32),
             "depth_mask": rng.rand(1, T, H, W) > 0.1,
             "intrinsics": K[None], "extrinsics": E[None], "target_T": Ts[None]}
    t_all = T + OUT_T
    box = np.concatenate([rng.rand(1, N, T, 2) * [W, H], 8 + rng.rand(1, N, T, 2) * 20,
                          rng.randn(1, N, T, 4)], -1)
    fg_in = {"trajectories": box.astype(np.float32),
             "bbox_masks": np.ones((1, N, t_all), bool),
             "bbox_vel_masks": np.arange(t_all)[None, None].repeat(N, 1) > 0,
             "depths": (rng.rand(1, N, T, 2) * [30, 1]).astype(np.float32),
             "depth_masks": np.ones((1, N, T, 1), bool),
             "feats": rng.rand(1, N, T, 8, 7, 7).astype(np.float32),
             "odometry": rng.randn(1, N, t_all, 5).astype(np.float32),
             "classes": rng.randint(0, 8, (1, N)),
             "output_inds": np.full((1, N), t_all - T - 1),
             "valid": np.arange(N)[None] < N - 1}
    step = build_forecast_step(bg, fg, height=H, width=W, out_t=OUT_T, device="cpu")
    return step, pc_in, fg_in


def test_forecast_spans_nest_in_order_and_change_no_output(tmp_path):
    step, pc_in, fg_in = forecast_case()
    untraced = step(pc_in, fg_in)
    prof = profiler()
    traced = step(pc_in, fg_in)
    prof.stop()
    got = spans(prof, tmp_path / "t.json")
    assert [n for n, *_ in got] == ["pf.forecast", "pf.forecast.pc", "pf.forecast.stage",
                                    "pf.forecast.bg", "pf.forecast.fg", "pf.forecast.stage",
                                    "pf.forecast.fusion"]
    outer, stages = got[0], [s for s in got if s[0] in STAGES]
    assert all(inside(s, outer) for s in stages)
    # the inputs' host passes, each inside the stage that reads them
    assert inside(got[2], got[1]) and inside(got[5], got[4])
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))
    assert sorted(traced) == sorted(untraced)
    for k in untraced:
        assert torch.equal(traced[k], untraced[k]), k
    assert (untraced["ids"] > 0).any()


def test_forecast_builds_no_span_without_a_profiler(monkeypatch):
    step, pc_in, fg_in = forecast_case()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert step(pc_in, fg_in)["panoptic"].shape == (1, H, W)


# ---- the training loop ------------------------------------------------------

ODOM = {
    "task": "odom", "seed": 0,
    "data": {"data_splits": ["train", "val"], "input_len": 9, "output_len": 9},
    "model": {"predict_type": "direct", "normalize_input": True,
              "use_normalized_loss": True, "rnn_hidden": 32, "loss_fn": "mse"},
    "training": {"batch_size": 8, "steps_per_epoch": 4, "num_epochs": 1,
                 "lr": 5e-3, "clip_grad_norm": 5.0, "use_adam": True,
                 "num_data_threads": 0},
}


@pytest.fixture(scope="module")
def odom_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("odom"))
    synthetic.write_odom_fixture(d, n_snippets=4)
    return d


def odom_cfg(data_dir, wd, **training):
    return dict(ODOM, working_dir=str(wd), data=dict(ODOM["data"], data_dir=data_dir),
                training=dict(ODOM["training"], **training))


def run_train(cfg, data=None):
    data = data or build_dataset(cfg)
    out = train(build_model(cfg, data.card, "cpu"), data, cfg)
    return out["history"], out["model"].state_dict()


def assert_same_run(a, b):
    assert a[0] == b[0]
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k


def check_batches(got, n_batches, accum, ended=True):
    """Each batch: ``pf.train.data``, then ``pf.train.step`` holding
    to_device, forward, backward and, on an accumulation boundary, optim,
    in that order. The fetch that ends the epoch is a data span of its own
    (``ended``); validation has no span."""
    names = [n for n, *_ in got]
    steps = [s for s in got if s[0] == "pf.train.step"]
    datas = [s for s in got if s[0] == "pf.train.data"]
    assert len(steps) == n_batches and len(datas) == n_batches + ended
    for i, st in enumerate(steps):
        assert datas[i][2] <= st[1] <= st[2]
        assert i + 1 == len(datas) or st[2] <= datas[i + 1][1]
        phases = [s for s in got if s[0] in PHASES and inside(s, st)]
        want = PHASES if (i + 1) % accum == 0 else PHASES[:3]
        assert [s[0] for s in phases] == want
        assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    assert set(names) == {"pf.train.data", "pf.train.step", *PHASES}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_spans_each_batch_and_change_no_result(odom_dir, tmp_path, accum):
    cfg = odom_cfg(odom_dir, tmp_path / "plain", accumulate_steps=accum,
                   batch_size=8 // accum)  # 4 updates of 4 * accum batches
    untraced = run_train(cfg)
    prof = profiler()
    traced = run_train(dict(cfg, working_dir=str(tmp_path / "traced")))
    prof.stop()
    check_batches(spans(prof, tmp_path / "t.json"), 4 * accum, accum)
    assert_same_run(traced, untraced)


class ProfilingLoader:
    """The train loader, with a profiler started inside the ``next()`` of
    batch ``start`` and stopped inside that of batch ``stop``: both calls
    run inside the loop's open ``pf.train.data`` span."""

    def __init__(self, loader, start, stop, path):
        self.loader, self.start, self.stop, self.path = loader, start, stop, path

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __iter__(self):
        prof = None
        for i, batch in enumerate(self.loader):
            if i == self.start:
                prof = profiler()
            if i == self.stop:
                prof.stop()
                prof.export_chrome_trace(self.path)
            yield batch


class ProfilingData:
    def __init__(self, data, *args):
        self.data, self.args = data, args
        self.datasets, self.card = data.datasets, data.card

    def loader(self, split, cfg, **kw):
        got = self.data.loader(split, cfg, **kw)
        return ProfilingLoader(got, *self.args) if split == "train" else got


def test_profiler_started_and_stopped_inside_spans(odom_dir, tmp_path):
    cfg = odom_cfg(odom_dir, tmp_path / "plain")
    untraced = run_train(cfg)
    path = str(tmp_path / "t.json")
    data = ProfilingData(build_dataset(cfg), 1, 3, path)
    traced = run_train(dict(cfg, working_dir=str(tmp_path / "traced")), data)
    assert_same_run(traced, untraced)
    got = read_spans(path)
    # batches 1 and 2 (of 0-3) ran whole under the profiler; the data span
    # that stopped it was entered while it recorded
    assert [n for n, *_ in got if n == "pf.train.step"] == ["pf.train.step"] * 2
    assert [n for n, *_ in got if n == "pf.train.optim"] == ["pf.train.optim"] * 2


def test_profile_dir_trace_holds_the_train_spans(odom_dir, tmp_path):
    cfg = odom_cfg(odom_dir, tmp_path / "wd", profile_dir=str(tmp_path / "trace"),
                   profile_steps=2)
    run_train(cfg)
    got = read_spans(os.path.join(tmp_path, "trace", "trace.json"))
    # the profiler stops after the second step closes, before the next fetch
    check_batches(got, 2, 1, ended=False)
