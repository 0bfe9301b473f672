"""Forecast cells: one camera's stream forecast back to back at batch 1,
closed loop, one client.

Set-up builds the bg and fg models at the configuration's widths, draws
their weights on the device from the seed, hands the program the bg
model to fold as it serves it, builds the step of
``eval/forecast.py::build_forecast_step`` and the traffic's scene pool
(host numpy), and runs each pool scene once, which warms every shape
the window uses. The window hands the step a fresh scene from the pool
each call, host arrays in, and ends a frame when its panoptic map is on
the host, read back into a pinned buffer of the harness (one a pool
scene). After the window the last frame of each pool scene is compared
with the plain reference.

The kind's faults (``FAULTS``), its control (``control``) and its cut to
the CPU's size (``tiny``) are here too.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import check, faults, flops, traffic, weights
from portbench.harness.trace import LIGHT_TRIES, Profiler, Traced, hook_ranges, mark

WARM_FRAMES = 3  # traced and dropped: the profiler's first records come late
TRACED_FRAMES = 24  # untraced on the host clock, then in each of the two traced windows


def build(cfg: Dict, seed: int, dev):
    """-> (step, bg folded, fg, (bg state, fg state) on the host)."""
    from panoptic_forecasting_tpu_torch.eval.forecast import build_forecast_step
    from panoptic_forecasting_tpu_torch.models.bg import BGModel
    from panoptic_forecasting_tpu_torch.models.fg import FGModel

    bg = weights.seed_(BGModel(cfg["bg"], depth_stats=tuple(cfg["depth_stats"]), device=dev),
                       seed, 10)
    fg = weights.seed_(FGModel(cfg["fg"], stats=cfg["fg_stats"], device=dev), seed, 11)
    states = (weights.host_state(bg.model), weights.host_state(fg))
    served = bg.maybe_fold()
    del bg
    step = build_forecast_step(served, fg, height=cfg["height"], width=cfg["width"],
                               out_t=cfg["out_t"], threshold=cfg["threshold"], device=dev)
    return step, served, fg, states


def reference(states, cfg: Dict, scenes, dev, conv=None, linear=None, deconv=None):
    from portbench.reference.forecast import forecast

    out = []
    for pc_in, fg_in in scenes:
        r = forecast(states[0], states[1], cfg, pc_in, fg_in, dev, conv, linear, deconv)
        r["valid"] = fg_in["valid"][0].astype(bool)
        out.append(r)
    return out


FAULTS = {"altered": faults.forecast_altered, "half_batch": faults.forecast_half_batch}


def control(spec: Dict, seed: int, dev, emulate: bool) -> Dict[str, float]:
    """The control's numbers: the reference in TF32 (``emulate``: operands
    rounded by hand, for the CPU) against the float32 reference."""
    from portbench.reference import precision

    cfg = spec["config"]
    states = build(cfg, seed, dev)[3]
    pool = traffic.make(spec["traffic"], cfg, seed, dev)
    want = reference(states, cfg, pool, dev)
    ops = (dict(conv=precision.conv, linear=precision.linear, deconv=precision.deconv)
           if emulate else {})
    with precision.card_tf32(not emulate):
        got = reference(states, cfg, pool, dev, **ops)
    return check.forecast_numbers(got, want)


def tiny(spec: Dict) -> None:
    """``spec`` cut to the CPU's size: 64x128, the fg ROI features
    32x7x7, a pool of 3 scenes."""
    c = spec["config"]
    c.update(height=64, width=128)
    c["bg"]["model"].update(final_h=64, final_w=128)
    c["fg"]["model"].update(mask_feat_channels=32, mask_feat_hw=7, mask_head={"conv_dim": 32})
    c["fg_stats"]["traj"] = [[x / 16 for x in v] for v in c["fg_stats"]["traj"]]
    spec["traffic"].update(pool=3)


def host(out: Dict) -> Dict:
    return {k: (v if isinstance(v, np.ndarray) else v[0].cpu().numpy())
            for k, v in out.items()}


def run(ctx) -> Dict:
    cfg, dev = ctx.config, ctx.device
    step, served, fg, states = build(cfg, ctx.seed, dev)
    ctx.mark("models")
    if ctx.fault is not None:
        step = ctx.fault(step)
    pool = traffic.make(ctx.traffic, cfg, ctx.seed, dev)
    ctx.mark("traffic")
    kept: Dict[int, Dict] = {}
    maps: Dict[int, torch.Tensor] = {}  # the host maps, pinned on a card

    def frame(i: int) -> None:
        k = i % len(pool)
        out = step(*pool[k])
        pan = out["panoptic"]
        if k not in maps:
            maps[k] = torch.empty(pan.shape, dtype=pan.dtype, pin_memory=dev.type == "cuda")
        maps[k].copy_(pan, non_blocking=True)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        kept[k] = {"panoptic": maps[k].numpy()[0], "ids": out["ids"], "bg_seg": out["bg_seg"],
                   "bbox": out["bbox"], "depths": out["depths"]}

    for i in range(len(pool)):
        frame(i)
    ctx.setup_done()

    result: Dict = {}
    if ctx.trace:
        t0 = time.perf_counter()
        for i in range(TRACED_FRAMES):
            frame(i)
        host_s = (time.perf_counter() - t0) / TRACED_FRAMES
        for _ in range(LIGHT_TRIES):
            light = Profiler(light=True)
            light.start()
            for i in range(WARM_FRAMES):
                frame(i)
            mark(dev)
            for i in range(TRACED_FRAMES):
                frame(WARM_FRAMES + i)
            mark(dev)
            light_trace = light.stop()
            if light_trace.whole() or dev.type != "cuda":
                break
        else:
            raise RuntimeError(f"no whole light window in {LIGHT_TRIES} tries")
        handles = hook_ranges(served, "bg_model") + hook_ranges(fg, "fg_model")
        prof = Profiler()
        prof.start()
        for i in range(WARM_FRAMES):
            frame(i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        with torch.profiler.record_function("pb.window"):
            for i in range(TRACED_FRAMES):
                with torch.profiler.record_function("pb.step"):
                    frame(WARM_FRAMES + i)
        result["trace"] = Traced(light_trace, prof.stop())
        for h in handles:
            h.remove()
        n = TRACED_FRAMES
        result["counts"] = {"frames": n, "host_s": host_s,
                            "flops": flops.forecast(cfg, int(ctx.traffic["slots"]))}
    else:
        lat: List[float] = []
        t0 = time.perf_counter()
        n = 0
        while True:
            ts = time.perf_counter()
            frame(n)
            lat.append(time.perf_counter() - ts)
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        span = time.perf_counter() - t0
        ctx.window_done()
        result["quarters_ms"] = [float(np.mean(q)) * 1e3 for q in np.array_split(lat, 4) if len(q)]
        result["metrics"] = {
            "forecast_ms": span * 1e3 / n,
            "forecast_p95_ms": float(np.percentile(np.array(lat) * 1e3, 95)),
        }
    result["attempted"], result["failed"] = n, 0
    result["memory_peak_bytes"] = ctx.memory_peak()
    got = {i: host(o) for i, o in kept.items()}
    del step, served, fg, kept
    ctx.free()
    idx = sorted(got)
    want = reference(states, cfg, [pool[i] for i in idx], dev)
    result["numbers"] = check.forecast_numbers([got[i] for i in idx], want)
    return result
