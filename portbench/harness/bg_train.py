"""bg training cells: ``train/loop.py::train`` at the configuration's
batch and crop, fed by one of two sources that the traffic's ``kind``
picks: ``crops``, the harness's own pool of batches in memory, cycled
(the data layer bypassed); ``files``, the port's own train loader
(``data/bg_data.py`` through ``data/pipelines.py``, its threads and
prefetch) over a file tree written at set-up (``harness/fixture.py``).

Set-up builds the bg model, draws its weights on the device from the
seed and writes them where ``cfg["load_model"]`` names them (``train()``
draws its own seeded weights first, then loads these). One ``train()``
call then runs set-up and window alike: its first three optimizer steps
(on three batches whose rows all differ) are set-up and the check's; the
window starts at the loader's fourth batch and ends at the first batch
asked for after ``--seconds``, when the loader ends the epoch. The device
is synchronised at both ends of the window.

The check reads what the program itself holds: each of the first three
steps' losses (a wrapper around ``model.loss``), the first gradient as
the optimizer got it (its momentum buffers after step one, by a global
optimizer step hook) and the parameters before step one and after step
three; the reference follows the same three steps. Over files it also
reads the first three batches that the loader handed ``train()``: the
reference decodes, crops and flips the same samples again.

The kind's faults (``FAULTS``; the data layer's ``faults.DATA_FAULTS``
join them where the traffic is ``files``), its control (``control``) and
its cut to the CPU's size (``tiny``) are here too.
"""

from __future__ import annotations

import copy
import itertools
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from portbench.harness import check, faults, fixture, flops, traffic, weights
from portbench.harness.trace import LIGHT_TRIES, Profiler, Traced, mark

CHECK_STEPS = 3
WARM_STEPS = 2  # traced and dropped: the profiler's first records come late
TRACED_STEPS = 5  # in each of the two traced windows (portbench/harness/trace.py)
HOST_STEPS = 8  # before them, untraced on the host clock


def _norms(ts) -> List[float]:
    return [float(t.detach().double().norm()) for t in ts]


class WindowLoader:
    """Hands ``train()`` the batches of ``source`` and keeps the run's
    clock: set-up ends and the window starts when batch ``CHECK_STEPS``
    is asked for; the epoch ends with the window. The first
    ``CHECK_STEPS`` batches are kept for the check."""

    def __init__(self, source, ctx, model, readings: Dict):
        self.source, self.ctx, self.model, self.r = source, ctx, model, readings

    def set_epoch(self, epoch: int) -> None:
        self.r["epoch"] = epoch
        if hasattr(self.source, "set_epoch"):
            self.source.set_epoch(epoch)

    def _sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _params(self):
        return [p.detach().clone() for p in self.model.parameters()]

    def __iter__(self):
        """With ``--trace 1`` the steps after set-up run ``HOST_STEPS``
        untraced on the host clock, then the light window (``WARM_STEPS``
        dropped, ``TRACED_STEPS`` between markers) and the full one (the
        same again, in a ``pb.window`` range)."""
        it = iter(self.source)
        try:
            yield from self._window(it)
        finally:
            if hasattr(it, "close"):
                it.close()

    def _window(self, it):
        ctx, r = self.ctx, self.r
        host1 = CHECK_STEPS + HOST_STEPS
        light0 = light1 = full0 = full1 = None  # set as the phases start
        i, prof, window, t0, resumed, tries, start_light = 0, None, None, 0.0, None, 0, False
        r["loader_wait_s"], r["loader_fetches"], r["batches"] = 0.0, 0, []
        while True:
            if i == 0:
                r["p0"] = self._params()
            elif i == CHECK_STEPS:
                r["p3"] = self._params()
                self._sync()
                ctx.setup_done()
                t0 = time.perf_counter()
                r["fetched"] = []
            if i >= CHECK_STEPS:
                r["fetched"].append(time.perf_counter())
            if ctx.trace and i == host1:
                self._sync()
                r["host_s"] = (time.perf_counter() - t0) / HOST_STEPS
                start_light = True
            if ctx.trace and i in (light0, light1):
                mark(ctx.device)
            if ctx.trace and i == light1:
                tr = prof.stop()
                if tr.whole() or ctx.device.type != "cuda":
                    r["light"] = tr
                    prof = Profiler()
                    prof.start()
                    full0 = i + WARM_STEPS
                    full1 = full0 + TRACED_STEPS
                elif tries == LIGHT_TRIES:
                    raise RuntimeError(f"no whole light window in {LIGHT_TRIES} tries")
                else:
                    start_light = True
            if start_light:
                start_light, tries = False, tries + 1
                prof = Profiler(light=True)
                prof.start()
                light0 = i + WARM_STEPS
                light1 = light0 + TRACED_STEPS
            if ctx.trace and i == full0:
                self._sync()
                window = torch.profiler.record_function("pb.window")
                window.__enter__()
            elif ctx.trace and i == full1:
                window.__exit__(None, None, None)
                r["trace"] = Traced(r["light"], prof.stop())
                r["steps"] = TRACED_STEPS
                return
            elif not ctx.trace and i > CHECK_STEPS and time.perf_counter() - t0 >= ctx.seconds:
                self._sync()
                r["span"], r["steps"] = time.perf_counter() - t0, i - CHECK_STEPS
                ctx.window_done()
                return
            batch = next(it)
            if i < CHECK_STEPS:
                r["batches"].append({k: (dict(v) if isinstance(v, dict) else v)
                                     for k, v in batch.items()})
            if CHECK_STEPS < i < host1:  # the loader's own time in the untraced steps
                r["loader_wait_s"] += time.perf_counter() - resumed
                r["loader_fetches"] += 1
            i += 1
            yield batch
            resumed = time.perf_counter()


def cycle(pool):
    """The pool's batches over and over, each a fresh dict."""
    for batch in itertools.cycle(pool):
        yield dict(batch)


class WindowData:
    """The task data ``train()`` asks for: a train split only, its loader
    ``make(split, cfg, seed, shard)`` wrapped in a ``WindowLoader``."""

    def __init__(self, make, ctx, model, readings: Dict):
        self.datasets = {"train": None}
        self.make, self.args = make, (ctx, model, readings)

    def loader(self, split, cfg, seed=0, shard=True):
        return WindowLoader(self.make(split, cfg, seed, shard), *self.args)


def build(cfg: Dict, seed: int, dev, depth_stats=None):
    """-> (the bg model with seeded weights, its HarDNet state on the
    host). ``depth_stats`` default to the configuration's."""
    from panoptic_forecasting_tpu_torch.models.bg import BGModel

    stats = tuple(depth_stats or cfg["depth_stats"])
    model = weights.seed_(BGModel(cfg, depth_stats=stats, device=dev), seed, 20)
    return model, weights.host_state(model.model)


def reference(state, batches, cfg: Dict, dev, conv=None) -> Dict:
    """The reference's readings over ``batches`` from ``state``."""
    from portbench.reference.train import train_steps

    losses, buf1, g1, p3 = train_steps(state, batches, cfg, dev, conv)
    return {"losses": losses, "grad": dict(zip(buf1, _norms(buf1.values()))),
            "raw_grad": dict(zip(g1, _norms(g1.values()))),
            "change": {k: float((p3[k].double() - state[k].to(dev).double()).norm())
                       for k in p3}}


FAULTS = {"half_batch": faults.train_half_batch, "unchanged": faults.train_unchanged,
          "altered": faults.train_altered}


def control(spec: Dict, seed: int, dev, emulate: bool) -> Dict[str, float]:
    """The control's numbers: the reference in TF32 (``emulate``: the
    convolutions' operands rounded by hand, for the CPU) against the
    float32 reference, over the first ``CHECK_STEPS`` batches."""
    from portbench.reference import precision

    cfg = spec["config"]
    state = build(cfg, seed, dev)[1]
    if spec["traffic"]["kind"] == "files":
        pool, stats = sample_batches(spec["traffic"], cfg, seed, dev)
        cfg = dict(cfg, depth_stats=stats)
    else:
        pool = traffic.make(spec["traffic"], cfg, seed, dev)[:CHECK_STEPS]
    want = reference(state, pool, cfg, dev)
    with precision.card_tf32(not emulate):
        got = reference(state, pool, cfg, dev, conv=precision.conv if emulate else None)
    return check.train_numbers(got, want)


def tiny(spec: Dict) -> None:
    """``spec`` cut to the CPU's size: crops 128 at batch 2; a pool of 4
    batches, or a file tree of 12 frames of 64x128."""
    spec["config"]["data"]["crop_size"] = 128
    spec["config"]["training"]["batch_size"] = 2
    t = spec["traffic"]
    if t["kind"] == "files":
        t.update(samples=12, size=[64, 128])
    else:
        t.update(pool=4, batch=2)


def sample_batches(params: Dict, cfg: Dict, seed: int, dev):
    """The ``files`` traffic's first ``CHECK_STEPS`` batches as the
    reference makes them, in the split's order (samples 0, 1, ... at
    epoch 1), and its depth statistics: the control's inputs."""
    from portbench.reference import bg_data

    d, bs = cfg["data"], int(cfg["training"]["batch_size"])
    rows = list(traffic.make(params, cfg, seed, dev))
    order = sorted(range(len(rows)), key=lambda i: fixture.stem(rows[i]["name"]))
    rows = [rows[i] for i in order]
    stats = bg_data.depth_stats([x["depth"] for x in rows], d["min_depth"], d["max_depth"])
    batches = [bg_data.batch(rows, range(k * bs, (k + 1) * bs), 1, int(d["crop_size"]),
                             (d["scale_min"], d["scale_max"])) for k in range(CHECK_STEPS)]
    return batches, stats


class _Files:
    """The ``files`` traffic: its tree written under the run's ``TMPDIR``,
    the port's train split over it, and the reference's view of it."""

    def __init__(self, ctx, cfg: Dict):
        self.root = tempfile.mkdtemp(prefix="portbench_bg_files_")
        t_in = int(cfg["model"]["num_inputs"])
        self.tree = fixture.write(traffic.make(ctx.traffic, cfg, ctx.seed, ctx.device),
                                  self.root, t_in)
        self.blocks = fixture.Blocks(self.tree["data"]["depth_h5_path"] % "train",
                                     self.tree["index"], self.tree["shape"])

    def task_data(self, run_cfg: Dict):
        """The port's bg task data over the tree (its depth statistics on
        its card), the depth file read through ``Blocks``."""
        from panoptic_forecasting_tpu_torch.core.registry import build_dataset
        from panoptic_forecasting_tpu_torch.data import io as pio

        run_cfg["data"].update(self.tree["data"], data_splits=["train"], gap_len=[9])
        opened, pio.open_h5 = pio.open_h5, lambda path: self.blocks
        try:
            return build_dataset(run_cfg)
        finally:
            pio.open_h5 = opened

    def reference(self, got: List[Dict], epoch: int, cfg: Dict):
        """(the reference's batches of the samples in ``got``, decoded,
        cropped and flipped again; its depth statistics)."""
        from portbench.reference import bg_data

        d = cfg["data"]
        entries = bg_data.listing(os.path.join(self.tree["data"]["gt_dir"], "train"))
        where = {stem: i for i, (_, _, stem) in enumerate(entries)}
        data = self.tree["data"]

        def depth(key):
            return np.fromfile(data["depth_h5_path"] % "train", np.uint16,
                               int(np.prod(self.tree["shape"])),
                               offset=self.tree["index"][key]).reshape(self.tree["shape"])

        stats = bg_data.depth_stats([depth("/".join([c] + s.split("_")[1:3] + ["0"]))
                                     for _, c, s in entries], d["min_depth"], d["max_depth"])
        out = []
        for b in got:
            meta = b["meta"]
            idx = [where[f"{c}_{s}_{int(f):06d}_gtFine"]
                   for c, s, f in zip(meta["city"], meta["seq"], meta["frame"])]
            rows = {i: bg_data.read_sample(data, "train", entries[i], depth) for i in idx}
            out.append(bg_data.batch(rows, idx, epoch, int(d["crop_size"]),
                                     (d["scale_min"], d["scale_max"])))
        return out, stats

    def close(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)


def run(ctx) -> Dict:
    from panoptic_forecasting_tpu_torch.train.loop import train

    cfg, dev = ctx.config, ctx.device
    run_cfg = copy.deepcopy({k: v for k, v in cfg.items() if k != "depth_stats"})
    run_cfg.update(seed=ctx.seed % 2**31, working_dir=tempfile.mkdtemp(prefix="portbench_wd_"))
    run_cfg["training"].update(num_epochs=1, val_interval=3)
    files = _Files(ctx, cfg) if ctx.traffic["kind"] == "files" else None
    task = None
    try:
        if files is not None:
            ctx.mark("traffic")
            task = files.task_data(run_cfg)
            card = task.card
            stats = (float(card.mean("depth")[0]), float(card.std("depth")[0]))
        else:
            stats = None
        model, state = build(cfg, ctx.seed, dev, stats)
        fd, path = tempfile.mkstemp(suffix=".pt", prefix="portbench_bg_")
        os.close(fd)
        torch.save(model.state_dict(), path)
        run_cfg["load_model"] = path
        ctx.mark("models")
        if files is None:
            pool = traffic.make(ctx.traffic, cfg, ctx.seed, dev)
            ctx.mark("traffic")

            def make(split, c, seed, shard):
                return cycle(pool)
        else:
            def make(split, c, seed, shard):
                return task.loader(split, c, seed=seed, shard=shard)
        r: Dict = {}
        names = [n[len("model."):] for n, _ in model.named_parameters()]

        losses: List[torch.Tensor] = []
        loss = model.loss

        def counted_loss(batch):
            out = loss(batch)
            if len(losses) < CHECK_STEPS:
                losses.append(out[0].detach().clone())
            return out

        model.loss = counted_loss

        def after_step(opt, args, kwargs):
            if "grad" not in r:
                r["grad"] = [opt.state[p]["momentum_buffer"].detach().clone()
                             for p in opt.param_groups[0]["params"]]

        hook = register_optimizer_step_post_hook(after_step)
        undo = ctx.fault(model) if ctx.fault is not None else None
        try:
            train(model, WindowData(make, ctx, model, r), run_cfg)
        finally:
            hook.remove()
            if undo is not None:
                undo()
            os.remove(path)
        result: Dict = {"attempted": r["steps"], "failed": 0}
        if ctx.trace:
            result["trace"] = r["trace"]
            result["counts"] = {"steps": r["steps"], "host_s": r["host_s"],
                                "loader_wait_ms": r["loader_wait_s"] * 1e3 / r["loader_fetches"],
                                "flops": flops.train_step(cfg, int(cfg["training"]["batch_size"]))}
        else:
            result["metrics"] = {"train_step_ms": r["span"] * 1e3 / r["steps"]}
            result["quarters_ms"] = [float(np.mean(np.diff(q))) * 1e3 for q in
                                     np.array_split(np.array(r["fetched"]), 4) if len(q) > 1]
        result["memory_peak_bytes"] = ctx.memory_peak()
        got = {"losses": [float(x) for x in losses],
               "grad": dict(zip(names, _norms(r["grad"]))),
               "change": dict(zip(names, _norms(a - b for a, b in zip(r["p3"], r["p0"]))))}
        batches, epoch = r["batches"], r.get("epoch", 1)
        del model, r, losses, task
        ctx.free()
        if files is None:
            result["numbers"] = check.train_numbers(
                got, reference(state, pool[:CHECK_STEPS], cfg, dev))
        else:
            want, ref_stats = files.reference(batches, epoch, cfg)
            result["numbers"] = check.train_numbers(
                got, reference(state, want, dict(cfg, depth_stats=ref_stats), dev))
            result["numbers"]["batch_off"] = check.batch_off(batches, want)
        return result
    finally:
        shutil.rmtree(run_cfg["working_dir"], ignore_errors=True)
        if files is not None:
            files.close()
