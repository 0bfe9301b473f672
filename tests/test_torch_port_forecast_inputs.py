"""The forecast step's inputs (``eval/inputs.py``): the CUDA branch's
staging, a pinned tensor and a copy an input, driven on the CPU with
stand-ins for streams and pinned memory, and the step's own
reads of its inputs: each converted once a call, device-resident ones
passed through, each host pass a ``pf.forecast.stage`` span.

Sizes: the forecast at 64x128 with 3 inputs and a small fg model, as in
tests/test_torch_port_tracing.py.
"""

import contextlib
import json
import types

import numpy as np
import pytest
import torch

from panoptic_forecasting_tpu_torch.eval import inputs as staging
from panoptic_forecasting_tpu_torch.eval.forecast import build_forecast_step
from panoptic_forecasting_tpu_torch.geometry import rdf_T_flu, unicycle_now_T_prev
from panoptic_forecasting_tpu_torch.models.bg import BGModel
from panoptic_forecasting_tpu_torch.models.fg import FGModel

torch.set_num_threads(2)

H, W, T, OUT_T, N = 64, 128, 3, 3, 4

# (source dtype, the staged dtype): the map dtypes, the fg dtypes and
# depth's cast from float64
CASTS = [(np.int32, torch.int32), (np.float32, torch.float32), (np.bool_, torch.bool),
         (np.int64, torch.int64), (np.float64, torch.float32)]


def source(rng, dtype, shape):
    if dtype == np.bool_:
        return rng.rand(*shape) > 0.4
    if np.issubdtype(dtype, np.integer):
        return rng.randint(-(2**31), 2**31 - 1, shape).astype(dtype)
    return (rng.randn(*shape) * 1e3).astype(dtype)


# ---- the CUDA branch on the CPU ------------------------------------------------

@pytest.fixture
def stand_ins(monkeypatch):
    """``eval/inputs.py``'s torch with CUDA streams and pinned memory
    replaced by host stand-ins; -> the list of their calls. The copy
    stream reads busy while ``Stream.busy`` is set."""
    class Log(list):
        pass

    log = Log()

    class Stream:
        busy = False

        def __init__(self, *args):
            pass

        def query(self):
            return not Stream.busy

        def wait_stream(self, other):
            log.append("wait")

    cuda = types.SimpleNamespace(
        Stream=Stream, current_stream=lambda dev: Stream(), current_device=lambda: 0,
        stream=lambda s: contextlib.nullcontext())

    class Torch:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def empty(shape, dtype=None, device=None, pin_memory=False):
            log.append(("pinned" if pin_memory else "device", tuple(np.atleast_1d(shape))))
            return torch.empty(shape, dtype=dtype)

    Torch.cuda = cuda
    monkeypatch.setattr(staging, "torch", Torch())
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None, raising=False)
    log.stream = Stream
    return log


@pytest.mark.parametrize("src_dtype,dtype", CASTS)
@pytest.mark.parametrize("shape", [(1, 3, 9, 11), (2, 0, 5)])
def test_packed_views_equal_their_sources(stand_ins, src_dtype, dtype, shape):
    """Each staged input reaches the device with its source's bits (after
    the same cast torch makes), an empty input included, its neighbours
    too, through a pinned tensor and a device tensor of its own. The step
    casts only the pc map ``depth``: a cast is staged as that map, any
    other input as an fg input."""
    rng = np.random.RandomState(0)
    x = source(rng, src_dtype, shape)
    inp = staging.Inputs(torch.device("cuda", 0))
    if torch.from_numpy(x).dtype == dtype:
        srcs = {"before": source(rng, np.int32, (3, 5)), "x": x,
                "after": source(rng, np.bool_, (7,))}
        got = inp.fg(srcs)
    else:
        srcs = {"seg": source(rng, np.int32, (3, 5)), "depth": x,
                "depth_mask": source(rng, np.bool_, (7,))}
        got = dict(zip(staging.PC_KEYS, inp.pc(srcs)))
    assert list(got) == list(srcs)
    for k, a in srcs.items():
        want = torch.from_numpy(a).to(dtype if a is x else torch.from_numpy(a).dtype)
        assert got[k].shape == want.shape and got[k].dtype == want.dtype
        assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8)), k
    shapes = [tuple(np.shape(a)) for a in srcs.values()]
    for kind in ("pinned", "device"):
        assert [e[1] for e in stand_ins if e != "wait" and e[0] == kind] == shapes
    assert inp.counters["htod_copies"] == 3 and stand_ins.count("wait") == 1


def scene(rng, h, w, n):
    pc = {"seg": rng.randint(0, 19, (1, T, h, w)).astype(np.int32),
          "depth": rng.rand(1, T, h, w) * 40,  # float64: the step casts it
          "depth_mask": rng.rand(1, T, h, w) > 0.2}
    fg = {"trajectories": rng.rand(1, n, T, 8).astype(np.float32),
          "feats": rng.rand(1, n, T, 8, 7, 7).astype(np.float32),
          "classes": rng.randint(0, 8, (1, n)),
          "bbox_masks": torch.ones(1, n, T + OUT_T, dtype=torch.bool),  # a CPU tensor
          "valid": np.arange(n)[None] < n - 1}
    return pc, fg


def test_staging_copies_each_pc_map_once_and_the_fg_inputs_in_one(stand_ins):
    """A pinned tensor, a device tensor and one copy an input; the pc maps
    in one staging pass and the fg inputs in another, the compute stream
    waiting once after each."""
    rng = np.random.RandomState(1)
    inp = staging.Inputs(torch.device("cuda", 0))
    waits = []
    for i, (h, w, n) in enumerate([(16, 40, 4), (16, 40, 4), (12, 40, 3), (20, 48, 6)]):
        pc, fg = scene(rng, h, w, n)
        stand_ins.stream.busy = i % 2 == 1
        before, logged = dict(inp.counters), len(stand_ins)
        seg, depth, mask = inp.pc(pc)
        out = inp.fg(fg)
        assert torch.equal(seg, torch.from_numpy(pc["seg"]))
        assert torch.equal(depth, torch.from_numpy(pc["depth"]).to(torch.float32))
        assert torch.equal(mask, torch.from_numpy(pc["depth_mask"]))
        assert list(out) == list(fg)
        for k, v in fg.items():
            assert torch.equal(out[k], torch.as_tensor(v)), k
        got = {k: inp.counters[k] - before[k] for k in inp.counters}
        fg_bytes = sum(torch.as_tensor(v).numel() * torch.as_tensor(v).element_size()
                       for v in fg.values())
        assert got["calls"] == 1 and got["bytes_passed_through"] == 0
        assert got["bytes_staged"] == T * h * w * (4 + 4 + 1) + fg_bytes
        assert got["htod_copies"] == 3 + len(fg)  # one an input
        calls = stand_ins[logged:]
        shapes = [(1, T, h, w)] * 3 + [tuple(np.shape(v)) for v in fg.values()]
        assert [e[1] for e in calls if e != "wait" and e[0] == "pinned"] == shapes
        assert [e[1] for e in calls if e != "wait" and e[0] == "device"] == shapes
        assert calls.count("wait") == 2
        waits.append(got["reuse_waits"])
    assert waits == [0, 1, 0, 1]  # a call begun while the copy stream ran


@pytest.mark.parametrize("pc_on_device", [False, True])
def test_staging_passes_device_tensors_through(stand_ins, pc_on_device):
    """A tensor on the step's device is read where it lies: nothing of it
    is staged or copied, and with every input there nothing is pinned.
    (The device here is ``meta``, whose tensors a CPU build can make.)"""
    rng = np.random.RandomState(2)
    pc, fg = scene(rng, 8, 16, 3)

    def meta(v):
        return torch.empty(np.shape(v), dtype=torch.as_tensor(v).dtype, device="meta")

    if pc_on_device:
        pc = {k: meta(v) for k, v in pc.items()}
    on_dev = {k: meta(v) for k, v in fg.items()}
    inp = staging.Inputs(torch.device("meta"))
    seg, depth, mask = inp.pc(pc)
    out = inp.fg(on_dev)
    assert all(out[k] is on_dev[k] for k in on_dev)
    assert depth.dtype == torch.float32 and (seg is pc["seg"]) == pc_on_device
    resident = list(on_dev.values()) + (list(pc.values()) if pc_on_device else [])
    assert inp.counters["bytes_passed_through"] == sum(
        v.numel() * v.element_size() for v in resident)
    staged = 0 if pc_on_device else T * 8 * 16 * 9  # the pc maps alone
    assert inp.counters["bytes_staged"] == staged
    assert inp.counters["htod_copies"] == (0 if pc_on_device else 3)  # one a pc map, no fg


# ---- the step ------------------------------------------------------------------

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


@pytest.fixture(scope="module")
def case():
    return forecast_case()


def test_each_input_is_converted_once_a_call(case, monkeypatch):
    step, pc_in, fg_in = case
    want = step(pc_in, fg_in)
    inputs = {id(v): k for k, v in {**fg_in, **{k: pc_in[k] for k in staging.PC_KEYS}}.items()}
    seen = dict.fromkeys(inputs.values(), 0)
    as_tensor = torch.as_tensor

    def counted(x, *args, **kwargs):
        if id(x) in inputs:
            seen[inputs[id(x)]] += 1
        return as_tensor(x, *args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", counted)
    got = step(pc_in, fg_in)
    assert seen == dict.fromkeys(inputs.values(), 1)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_resident_inputs_pass_through(case, kind):
    """On the CPU every input is where the step reads it: nothing staged,
    nothing copied, the outputs those of numpy inputs."""
    step, pc_in, fg_in = case
    want = step(pc_in, fg_in)
    if kind == "tensor":
        pc_in = {k: torch.as_tensor(v) for k, v in pc_in.items()}
        fg_in = {k: torch.as_tensor(v) for k, v in fg_in.items()}
    before = dict(step.counters)
    got = step(pc_in, fg_in)
    counts = {k: step.counters[k] - before[k] for k in step.counters}
    nbytes = sum(np.asarray(pc_in[k]).nbytes for k in staging.PC_KEYS)
    nbytes += sum(np.asarray(v).nbytes for v in fg_in.values())
    assert counts == {"calls": 1, "bytes_staged": 0, "bytes_passed_through": nbytes,
                      "htod_copies": 0, "reuse_waits": 0}
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_stage_span_lies_in_the_stage_that_reads_the_inputs(case, tmp_path):
    step, pc_in, fg_in = case
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    step(pc_in, fg_in)
    prof.stop()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        events = json.load(f)["traceEvents"]
    got = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("cat") == "user_annotation"
                  and e["name"].startswith("pf.")), key=lambda s: (s[1], -s[2]))
    named = {n: [s for s in got if s[0] == n] for n in
             ("pf.forecast", "pf.forecast.pc", "pf.forecast.fg", "pf.forecast.stage")}
    (outer,), (pc,), (fg,) = (named[k] for k in ("pf.forecast", "pf.forecast.pc",
                                                  "pf.forecast.fg"))
    stages = named["pf.forecast.stage"]
    assert len(stages) == 2

    def inside(a, b):
        return b[1] <= a[1] and a[2] <= b[2]

    assert all(inside(s, outer) for s in stages)
    assert inside(stages[0], pc) and inside(stages[1], fg)
