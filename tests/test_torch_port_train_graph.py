"""The trainer's step graphs (``train/graph.py``) on the CPU.

CUDA graphs exist only on the card, so the capture is stood in for at
the trainer's own seam: ``graph.DEVICE_TYPE`` set to the CPU and
``graph.capture`` replaced by a capture that runs nothing and replays
its function with the learning rates it saw at capture, as a CUDA graph
keeps the optimizer's scalars. Everything around it runs as on the card:
which batches replay and which run eager (and why), the batch copied
through its host buffers and staging set into the captured inputs (on
the CPU plain tensors, the copy stream and its events stood in for by
``graph._Host``), the three graphs in their spans, the update graph
captured again for a new rate, the counters.

A run with the stand-in is held bit-equal to the same run all eager
(the plain CPU path): the bg model (``BGModel``, HarDNet in train mode)
at crop 64, batch 2, SGD with momentum, decay and clip-norm 5 as
``configs/bg/bg_train.yaml`` sets them.
"""

import copy
import json
import os
import weakref

import numpy as np
import pytest
import torch

from panoptic_forecasting_tpu_torch.models.bg import BGModel
from panoptic_forecasting_tpu_torch.train import graph
from panoptic_forecasting_tpu_torch.train.loop import train

torch.set_num_threads(2)
CROP, BATCH = 64, 2
TRAINING = {"batch_size": BATCH, "num_epochs": 1, "lr": 2e-3, "mom": 0.9, "wd": 1e-4,
            "clip_grad_norm": 5.0, "val_interval": 100}


def bg_cfg(wd, **training):
    return {"task": "bg", "seed": 0, "working_dir": str(wd),
            "data": {"num_classes": 11, "min_depth": 0.1, "max_depth": 200,
                     "crop_size": CROP},
            "model": {"num_inputs": 3, "use_depth_inps": True, "convert2onehot": True},
            "training": dict(TRAINING, **training)}


def make_batch(seed, size=CROP, label_dtype=np.uint8, extra=False):
    """A bg batch in the train loader's format: trainId segs (uint8), raw
    uint16 depth, GT with 255 where things are."""
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 11, (BATCH, size, size)).astype(label_dtype)
    gt[:, : size // 4, : size // 3] = 255
    out = {"inputs": {"seg": rng.integers(0, 11, (BATCH, 3, size, size)).astype(np.uint8),
                      "depth": rng.integers(0, 50000, (BATCH, 3, size, size))
                      .astype(np.uint16)},
           "labels": {"seg": gt}, "meta": {"frame": np.arange(BATCH)}}
    if extra:
        out["labels"]["unused"] = np.zeros(BATCH, np.float32)
    return out


class Data:
    """Task data over fixed epochs of batches: epoch e hands out
    ``epochs[e - 1]``, each batch a fresh dict, and records what it
    handed out."""

    def __init__(self, epochs):
        self.epochs, self.datasets, self.handed = epochs, {"train": None}, []

    def loader(self, split, cfg, seed=0, shard=True):
        return self

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        for i, b in enumerate(self.epochs[self.epoch - 1]):
            self.handed.append((self.epoch, i))
            yield dict(b)


class Overwriting(Data):
    """As ``Data``, but each batch's arrays are overwritten as soon as the
    next batch is asked for: a caller reusing its buffers."""

    def __iter__(self):
        for b in super().__iter__():
            yield b
            for part in (b["inputs"], b["labels"]):
                for a in part.values():
                    a[...] = 7


class Counted(BGModel):
    """The bg model, counting its forward passes in train mode."""

    forwards = 0

    def loss(self, batch):
        self.forwards += 1
        return super().loss(batch)


def run(tmp_path, epochs, name="run", data_cls=None, **training):
    cfg = bg_cfg(tmp_path / name, **training)
    model = Counted(cfg, depth_stats=(20.0, 12.0), device="cpu")
    data = (data_cls or Data)(epochs)
    out = train(model, data, cfg)
    return out, model, data


def state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def assert_equal_states(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def assert_adds_up(counters, steps):
    assert counters["steps"] == steps
    assert counters["replays"] + sum(counters["eager"].values()) == steps


@pytest.fixture
def stand_in(monkeypatch):
    """The CPU as the graphs' device and a capture that runs nothing; its
    replay runs the function at the rates the capture saw. -> the names
    of the functions captured, in order."""
    captured = []

    def capture(fn, pool=None):
        groups = fn.__self__.opt.inner.param_groups
        rates = [g["lr"] for g in groups]
        captured.append(fn.__name__)

        def replay():
            now = [g["lr"] for g in groups]
            for g, r in zip(groups, rates):
                g["lr"] = r
            try:
                fn()
            finally:
                for g, r in zip(groups, now):
                    g["lr"] = r

        return replay, pool

    monkeypatch.setattr(graph, "DEVICE_TYPE", "cpu")
    monkeypatch.setattr(graph, "capture", capture)
    return captured


def test_the_cpu_runs_every_step_eager(tmp_path):
    out, model, _ = run(tmp_path, [[make_batch(i) for i in range(3)]])
    c = out["graph"]
    assert_adds_up(c, 3)
    assert c["eager"]["cpu"] == 3 and c["replays"] == c["captures"] == 0
    assert out["step"] == 3 and model.forwards == 3


def test_replayed_steps_train_each_batch_once_as_the_eager_steps(tmp_path, stand_in):
    """The first step eager, the second captured (forward, backward,
    update) and replayed, the rest replayed: parameters, BN statistics
    and momentum equal to the eager run's; one forward a batch."""
    epochs = [[make_batch(i) for i in range(5)]]
    got, model, data = run(tmp_path, epochs)
    c = got["graph"]
    assert_adds_up(c, 5)
    assert c["eager"]["first_step"] == 1 and sum(c["eager"].values()) == 1
    assert c["captures"] == 1 and c["replays"] == 4 and c["optim_captures"] == 0
    assert stand_in == ["_forward", "_backward", "_update"]
    assert data.handed == [(1, i) for i in range(5)] and model.forwards == 5
    assert int(model.state_dict()["model.base.0.norm.num_batches_tracked"]) == 5
    assert got["step"] == 5
    assert all(p.grad is None for p in model.parameters())
    graphed = state(model)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graph, "DEVICE_TYPE", "cuda")  # the plain CPU path
        want, eager, _ = run(tmp_path, epochs, "eager")
    assert want["graph"]["eager"]["cpu"] == 5
    assert_equal_states(graphed, state(eager))


@pytest.mark.parametrize("busy", [(), (1, 3)], ids=["never_busy", "busy_twice"])
def test_staged_steps_equal_the_eager_ones_and_count_their_waits(tmp_path, stand_in,
                                                                  monkeypatch, busy):
    """Every replayed batch goes through the host buffers and the staging
    set (``staged == replays``). Where the last DMA still reads the host
    buffers (the stand-in event reads busy at the host passes ``busy``,
    counted from 0), the host waits for it before the pass and counts the
    wait. Parameters, BN statistics and momentum equal the eager run's."""
    queries, synced = [], []
    monkeypatch.setattr(graph._Host, "query",
                        lambda self: (queries.append(1), len(queries) - 1 not in busy)[1])
    monkeypatch.setattr(graph._Host, "synchronize", lambda self: synced.append(len(queries)))
    epochs = [[make_batch(i) for i in range(5)]]
    got, model, _ = run(tmp_path, epochs)
    c = got["graph"]
    assert_adds_up(c, 5)
    assert c["replays"] == 4 and c["staged"] == c["replays"] and len(queries) == 4
    assert c["stage_waits"] == len(busy) and synced == [i + 1 for i in busy]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graph, "DEVICE_TYPE", "cuda")
        want, eager, _ = run(tmp_path, epochs, "eager")
    assert want["graph"]["staged"] == want["graph"]["stage_waits"] == 0
    assert_equal_states(state(model), state(eager))


def test_the_host_pass_ends_inside_the_step(tmp_path, stand_in):
    """The loader overwrites each batch's arrays once the next is asked
    for: the run trains as on untouched arrays (the eager run's), so
    nothing reads the caller's arrays after ``step`` returns."""
    epochs = [[make_batch(i) for i in range(5)]]
    got, model, data = run(tmp_path, copy.deepcopy(epochs), data_cls=Overwriting)
    assert got["graph"]["staged"] == 4 and data.handed == [(1, i) for i in range(5)]
    assert all((a == 7).all() for b in data.epochs[0] for a in b["inputs"].values())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graph, "DEVICE_TYPE", "cuda")
        _, eager, _ = run(tmp_path, epochs, "eager")
    assert_equal_states(state(model), state(eager))


def test_the_eager_steps_autograd_graph_is_gone_at_the_capture(tmp_path, stand_in,
                                                                 monkeypatch):
    """A capture reuses a live gradient accumulator, which launches on the
    stream it was made on; the first step's (the default stream, which
    cannot join a capture) must be gone: no tensor of its loss lives."""
    outputs = []
    loss = Counted.loss

    def kept(self, batch):
        out = loss(self, batch)
        outputs.append([weakref.ref(out[0])] + [weakref.ref(v) for v in out[1].values()])
        return out

    alive = []
    capture = graph.capture

    def checked(fn, pool=None):
        if fn.__name__ == "_forward":
            alive.append(sum(r() is not None for r in outputs[0]))
        return capture(fn, pool)

    monkeypatch.setattr(Counted, "loss", kept)
    monkeypatch.setattr(graph, "capture", checked)
    out, _, _ = run(tmp_path, [[make_batch(i) for i in range(3)]])
    assert out["graph"]["captures"] == 1 and alive == [0]


@pytest.mark.parametrize("change", ["shape", "dtype", "keys"])
def test_a_changed_batch_runs_eager_and_the_graphs_resume(tmp_path, stand_in, change):
    """Batch 4 of 6 differs from the captured one: it runs eager (its own
    gradients, the shared momentum), and batches 5 and 6 replay again."""
    odd = {"shape": dict(size=2 * CROP), "dtype": dict(label_dtype=np.int64),
           "keys": dict(extra=True)}[change]
    epochs = [[make_batch(i, **(odd if i == 3 else {})) for i in range(6)]]
    got, model, data = run(tmp_path, epochs)
    c = got["graph"]
    assert_adds_up(c, 6)
    assert c["eager"]["first_step"] == 1 and c["eager"]["signature"] == 1
    assert c["replays"] == 4 and c["captures"] == 1
    assert model.forwards == 6 and got["step"] == 6
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graph, "DEVICE_TYPE", "cuda")
        _, eager, _ = run(tmp_path, epochs, "eager")
    assert_equal_states(state(model), state(eager))


@pytest.mark.parametrize("change", ["shape", "dtype", "keys"])
def test_the_graphs_resume_into_the_same_staging_tensors(tmp_path, stand_in, monkeypatch,
                                                         change):
    """After a batch of another signature has run eager, the replayed
    batches go through the host buffers, staging set and captured inputs
    allocated at the capture: the same tensors at the same addresses,
    allocated once."""
    odd = {"shape": dict(size=2 * CROP), "dtype": dict(label_dtype=np.int64),
           "keys": dict(extra=True)}[change]
    seen, allocs = [], []
    stage, allocate = graph.StepGraphs._stage, graph.StepGraphs._allocate

    def staged(self):
        stage(self)
        seen.append([(id(t), t.data_ptr())
                     for t in self._pinned + self._staging + self._static])

    monkeypatch.setattr(graph.StepGraphs, "_stage", staged)
    monkeypatch.setattr(graph.StepGraphs, "_allocate",
                        lambda self, leaves: (allocs.append(1), allocate(self, leaves)))
    epochs = [[make_batch(i, **(odd if i == 3 else {})) for i in range(6)]]
    got, _, _ = run(tmp_path, epochs)
    c = got["graph"]
    assert c["eager"]["signature"] == 1 and c["staged"] == c["replays"] == 4
    assert len(seen) == 4 and allocs == [1] and len(seen[0]) == 9
    assert all(s == seen[0] for s in seen)


@pytest.mark.parametrize("reason, training", [
    ("accumulate", {"accumulate_steps": 2}),
    ("optimizer", {"use_adam": True}),
    ("optimizer", {"use_adamw": True}),
], ids=["accumulate", "adam", "adamw"])
def test_steps_the_graphs_cannot_hold_run_eager(tmp_path, stand_in, reason, training):
    out, model, _ = run(tmp_path, [[make_batch(i) for i in range(4)]], **training)
    c = out["graph"]
    assert_adds_up(c, 4)
    assert c["eager"][reason] == 4 and c["replays"] == c["captures"] == 0
    assert stand_in == [] and model.forwards == 4


def test_each_epochs_rate_reaches_the_replayed_step(tmp_path, stand_in, monkeypatch):
    """Two epochs under ``lr_decay_type: step`` (the rate a tenth in the
    second): the update graph is captured again for the new rate, and
    the run equals the eager one. Held at the first rate, it does not."""
    epochs = [[make_batch(i) for i in range(3)], [make_batch(i) for i in range(3, 6)]]
    sched = dict(num_epochs=2, lr_decay_type="step", lr_decay_steps=1, lr_decay_factor=0.1)
    got, model, data = run(tmp_path, epochs, **sched)
    c = got["graph"]
    assert_adds_up(c, 6)
    assert c["captures"] == 1 and c["optim_captures"] == 1 and c["replays"] == 5
    assert stand_in == ["_forward", "_backward", "_update", "_update"]
    assert data.handed == [(e, i) for e in (1, 2) for i in range(3)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graph, "DEVICE_TYPE", "cuda")
        _, eager, _ = run(tmp_path, epochs, "eager", **sched)
    assert_equal_states(state(model), state(eager))

    monkeypatch.setattr(graph.StepGraphs, "_lrs", lambda self: (2e-3,))
    _, held, _ = run(tmp_path, epochs, "held", **sched)
    assert not torch.equal(state(held)["model.base.0.conv.weight"],
                           state(eager)["model.base.0.conv.weight"])


def test_replays_run_in_the_eager_steps_spans(tmp_path, stand_in):
    """Every step's work inside ``pf.train.step``: the copies in
    ``.to_device``, the loss in ``.forward``, the optimizer in ``.optim``,
    once a step, replayed or eager."""
    wd = tmp_path / "prof"
    out, _, _ = run(tmp_path, [[make_batch(i) for i in range(3)]], "prof",
                    profile_dir=str(wd / "trace"), profile_steps=3)
    assert out["graph"]["replays"] == 2
    with open(os.path.join(wd, "trace", "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]

    def inside(name, outer):
        spans = [e for e in events if e["name"] == outer]
        return [sum(1 for e in events if e["name"] == name
                    and s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"])
                for s in spans]

    assert len([e for e in events if e["name"] == "pf.train.step"]) == 3
    for outer in ("pf.train.to_device", "pf.train.forward", "pf.train.backward",
                  "pf.train.optim"):
        assert inside(outer, "pf.train.step") == [1, 1, 1], outer
    assert inside("Optimizer.step#SGD.step", "pf.train.optim") == [1, 1, 1]
    assert inside("aten::convolution", "pf.train.forward")[0] > 0
    assert len(set(inside("aten::convolution", "pf.train.forward"))) == 1


def test_two_ranks_run_eager(tmp_path):
    """A process group (two gloo ranks, the stand-in in each): every step
    eager under ``ranks``."""
    from panoptic_forecasting_tpu_torch.data import synthetic
    from test_torch_port_parallel import _odom_argv, run_ranks

    data_dir = str(tmp_path / "odom")
    synthetic.write_odom_fixture(data_dir, n_snippets=2)
    wd = str(tmp_path / "two")
    _, (r0, r1) = run_ranks("train", {"argv": _odom_argv(data_dir, wd, 1),
                                      "working_dir": wd, "stand_in": True}, tmp_path)
    for r in (r0, r1):
        c = r["graph"]
        assert_adds_up(c, r["step"])
        assert r["step"] > 0 and c["eager"]["ranks"] == r["step"] and c["replays"] == 0
