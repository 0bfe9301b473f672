#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the single-call panoptic forecast
(``panoptic_forecasting_tpu_torch.eval.build_forecast_step``), once at
full width: FCHarDNet-70 (configs/bg/bg_val_short.yaml: 3 reprojected
frames, one-hot + depth, 11 stuff classes, folded BN, 1024x2048) and the
foreground model of configs/fg/fg_val_short.yaml (rnn_hidden 128, 2
ConvLSTM layers, 2 trajectory-output layers, 256x14x14 ROI features,
mask head conv_dim 256), 8 instance slots, out_t = 3. Weights are random
from a fixed seed; inputs are synthetic, made as bench.py's fused
benchmark makes them.

Phases (any failure exits non-zero):
  1. build both CUDA kernels from csrc/ with nvcc (in parallel);
  2. K1 (place_min) against its plain version on a full-size stream from
     a real reprojection: bit-equal;
  3. K2 (onehot_stem_conv) against its plain version at (1,3,1024,2048):
     max abs diff <= 1e-5 (f32 sums taken in another order);
  4. the full-width step with every launch counter set to 0 just before
     and read just after: both kernels must have launched;
  5. the same step on the GPU and on the CPU at 256x512: ids equal,
     panoptic maps differing on < 1e-3 of pixels;
  6. timings with CUDA events after warm-up (kernels, their plain
     versions, one PyTorch library call each, one whole step).

Prints the card's name and power limit, one JSON line describing every
kernel, and last a JSON line {"ok": true, "device": {...}}. Exits non-zero
without a result when CUDA is unavailable.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from panoptic_forecasting_tpu_torch.eval import build_forecast_step
from panoptic_forecasting_tpu_torch.geometry import rdf_T_flu, unicycle_now_T_prev
from panoptic_forecasting_tpu_torch.kernels import build
from panoptic_forecasting_tpu_torch.kernels.placement import (
    EMPTY, place_min, place_min_plain,
)
from panoptic_forecasting_tpu_torch.kernels.stem import (
    assemble_onehot, onehot_stem_conv, onehot_stem_conv_plain,
)
from panoptic_forecasting_tpu_torch.kernels.zbuffer import splat_stream
from panoptic_forecasting_tpu_torch.models import BGModel, FGModel, seeded_init_
from panoptic_forecasting_tpu_torch.models.pc_transform import (
    pc_transform_predict, reproject,
)

SEED = 0
H, W, T_IN = 1024, 2048, 3
H_SMALL, W_SMALL = 256, 512
N_INST, OUT_T = 8, 3
INTR = (2262.52, 2265.30, 1096.98, 513.137)  # bench.py's Cityscapes camera
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOP_PER_S = 67e12  # H100 SXM, non-tensor f32

BG_CFG = {
    "model": {"num_inputs": T_IN, "use_depth_inps": True,
              "convert2onehot": True},
    "data": {"num_classes": 11, "min_depth": 0.1, "max_depth": 200},
}
FG_CFG = {
    "model": {
        "instance_feat_channels": 8, "instance_feat_hidden": 64,
        "num_convlstm_layers": 2, "num_traj_out_layers": 2,
        "rnn_hidden": 128, "rnn_type": "gru", "traj_feat_channels": 16,
        "use_depth_inp": True, "use_odometry": True,
        "use_depth_sorting": True, "mask_head": {},
    },
}
DEPTH_STATS = (20.0, 12.0)


def fg_stats(width: int):
    """Normalisation statistics of the synthetic traffic (data-card
    stand-ins); box statistics in pixels of a ``width``-wide image."""
    s = width / 2048.0
    return {
        "traj": (np.array([1024, 512, 150, 150, 0, 0, 0, 0]) * s,
                 np.array([300, 80, 40, 40, 10, 5, 2, 2]) * s),
        "depth": ([20.0, 0.0], [10.0, 1.0]),
        "odom": ([8.2, 0.0, 0.5, 0.0, 0.0], [0.3, 0.01, 0.02, 1.0, 1.0]),
    }


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_models(device, height: int = H, width: int = W):
    """Full-width bg (folded, output at height x width) and fg models,
    weights from SEED."""
    cfg = copy.deepcopy(BG_CFG)
    cfg["model"].update(final_h=height, final_w=width)
    bg = seeded_init_(BGModel(cfg, depth_stats=DEPTH_STATS, device="cpu"), SEED)
    bg = bg.maybe_fold().to(device)
    fg = seeded_init_(FGModel(FG_CFG, stats=fg_stats(width), device="cpu"),
                      SEED + 1)
    return bg, fg.to(device)


def make_inputs(height: int, width: int):
    """Synthetic pc + fg inputs (numpy), as bench.py::measure_fused makes
    them: random stuff labels, depths 2-52 m, a car driving ~8 m/s."""
    rng = np.random.RandomState(SEED)
    s = width / 2048.0
    seg = rng.randint(0, 11, size=(1, T_IN, height, width)).astype(np.int32)
    depth = (rng.rand(1, T_IN, height, width) * 50 + 2).astype(np.float32)
    K = np.array([[INTR[0] * s, 0, INTR[2] * s], [0, INTR[1] * s, INTR[3] * s],
                  [0, 0, 1]], np.float32)
    E = (np.array([[1, 0, 0, 0.3], [0, 1, 0, 0.0], [0, 0, 1, 1.2],
                   [0, 0, 0, 1]], np.float32) @ rdf_T_flu()).astype(np.float32)
    Ts = unicycle_now_T_prev(np.array([8.0, 8.2, 8.4], np.float32),
                             np.array([0.01, 0.0, -0.01], np.float32), 0.18).numpy()
    pc_in = {
        "seg": seg, "depth": depth,
        "depth_mask": np.ones_like(depth, bool),
        "intrinsics": K[None], "extrinsics": E[None], "target_T": Ts[None],
    }
    n, t_all = N_INST, T_IN + OUT_T
    box0 = np.stack([rng.uniform(300, 1750, n), rng.uniform(350, 650, n),
                     rng.uniform(60, 250, n), rng.uniform(60, 250, n)], -1) * s
    vel = rng.uniform(-8, 8, (n, 4)) * s
    vel[:, 2:] *= 0.2
    traj = np.zeros((n, T_IN, 8), np.float32)
    for t in range(T_IN):
        traj[:, t, :4] = box0 + t * vel
        traj[:, t, 4:] = vel if t else 0.0
    d0 = rng.uniform(6, 40, n)
    depths = np.stack([d0[:, None] + np.arange(T_IN) * 0.1,
                       np.full((n, T_IN), 0.1)], -1).astype(np.float32)
    vel_mask = np.ones((n, t_all), bool)
    vel_mask[:, 0] = False
    odom = np.zeros((n, t_all, 5), np.float32)
    odom[..., 0] = 8.2 + rng.randn(n, t_all) * 0.1
    odom[..., 1] = rng.randn(n, t_all) * 0.01
    odom[..., 2] = 0.5
    fg_in = {
        "trajectories": traj,
        "bbox_masks": np.ones((n, t_all), bool),
        "bbox_vel_masks": vel_mask,
        "depths": depths,
        "depth_masks": np.ones((n, T_IN, 1), bool),
        "feats": np.maximum(rng.randn(n, T_IN, 256, 14, 14), 0).astype(np.float32),
        "odometry": odom,
        "classes": rng.randint(0, 8, n),
        "output_inds": np.full(n, OUT_T - 1),
        "valid": np.ones(n, bool),
    }
    return pc_in, {k: v[None] for k, v in fg_in.items()}


def pc_args(pc_in, device):
    """Step 1's arguments to the reprojection: each past frame its own
    batch entry (B·T, 1, H, W), camera matrices left on the host."""
    def flat(x):
        x = torch.as_tensor(x)
        return x.reshape((T_IN, 1) + tuple(x.shape[2:]))

    return (
        flat(pc_in["seg"]).to(device), flat(pc_in["depth"]).to(device),
        flat(pc_in["depth_mask"]).to(device),
        torch.as_tensor(pc_in["intrinsics"]).repeat_interleave(T_IN, 0),
        torch.as_tensor(pc_in["extrinsics"]).repeat_interleave(T_IN, 0),
        flat(pc_in["target_T"]).reshape(T_IN, 1, 4, 4),
    )


def k1_inputs(pc_in, device):
    """The (group, key) stream K1 gets in the step (one canvas per frame)."""
    uv, z, label, valid = reproject(*pc_args(pc_in, device), height=H, width=W)
    return splat_stream(uv, z, label, valid, height=H, width=W)


def k2_inputs(bg, pc_in, device):
    """The fused stem's inputs in the step: the per-frame reprojected seg
    canvases and their normalised, masked depth channels."""
    rep = pc_transform_predict(*pc_args(pc_in, device), height=H, width=W)
    rep_depth = rep["depth"].reshape(1, T_IN, H, W)
    seg, dep = bg.stem_inputs({"seg": rep["seg"].reshape(1, T_IN, H, W),
                               "depth": rep_depth.clamp(min=0.0),
                               "depth_mask": rep_depth > 0})
    conv = bg.model.base[0].conv
    kern = conv.weight.detach().permute(2, 3, 1, 0).contiguous()
    return seg, dep, kern, conv.bias.detach()


def edge_cases(dev):
    """Both kernels against their plain versions off the main path's
    shapes: K1 with ignored groups (negative, >= num_groups) and key 0;
    K2 batched, without depth, with other class/frame counts and ids
    outside [0, C)."""
    g = torch.Generator().manual_seed(SEED)
    group = torch.randint(-50, 5000, (20000,), generator=g, dtype=torch.int32)
    key = torch.randint(0, 2**31 - 2, (20000,), generator=g, dtype=torch.int32)
    key[::9] = 0
    group, key = group.to(dev), key.to(dev)
    for n_groups in (4000, 5000, 1):
        if not torch.equal(place_min(group, key, n_groups),
                           place_min_plain(group, key, n_groups)):
            raise SystemExit(f"K1 edge case num_groups={n_groups} differs")
    worst = 0.0
    for b, t, h, w, c, depth in ((2, 3, 34, 66, 11, True), (1, 2, 16, 48, 5, True),
                                 (1, 3, 20, 30, 11, False)):
        seg = torch.randint(-2, c + 3, (b, t, h, w), generator=g, dtype=torch.int32)
        dep = torch.randn(b, t, h, w, generator=g) if depth else None
        c_in = t * c + (t if depth else 0)
        kern = torch.randn(3, 3, c_in, 16, generator=g) * 0.2
        bias = torch.randn(16, generator=g)
        args = [x.to(dev) if x is not None else None for x in (seg, dep, kern, bias)]
        err = float((onehot_stem_conv(*args, num_classes=c)
                     - onehot_stem_conv_plain(*args, num_classes=c)).abs().max())
        worst = max(worst, err)
    print(f"[edge] K1 ignored groups + key 0 bit-equal; K2 batched/no-depth/"
          f"other C: max abs diff {worst:.3e}")
    if not worst <= 1e-5:
        raise SystemExit(f"K2 edge cases differ by {worst}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k2_flops(seg, num_classes: int) -> float:
    """Operations K2 does on this data: 16 adds per tap whose class is in
    range, an FMA (2) per channel per in-bounds depth tap, bias + ReLU."""
    ones = torch.ones(1, 1, 3, 3, device=seg.device)
    b, t, h, w = seg.shape
    in_range = ((seg >= 0) & (seg < num_classes)).float().reshape(b * t, 1, h, w)
    taps = F.conv2d(in_range, ones, stride=2, padding=1).sum().item()
    inb = F.conv2d(torch.ones_like(in_range), ones, stride=2, padding=1).sum().item()
    pixels = b * (h // 2) * (w // 2)
    return 16 * taps + 32 * inb + 32 * pixels


def stage_breakdown(step, bg, fg, pc_in, fg_in, dev):
    """Where the step's time goes: each stage alone on device-resident
    inputs (CUDA events), then one step under torch.profiler for the
    device-busy share and the costliest kernels."""
    pc_dev = {k: torch.as_tensor(v).to(dev) if k in ("seg", "depth", "depth_mask")
              else torch.as_tensor(v) for k, v in pc_in.items()}
    fg_dev = {k: torch.as_tensor(v).to(dev) for k, v in fg_in.items()}
    fg_flat = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in fg_dev.items()
               if k != "valid"}
    args = pc_args(pc_dev, dev)

    def pc_stage():
        return pc_transform_predict(*args, height=H, width=W)

    rep = pc_stage()
    rep_depth = rep["depth"].reshape(1, T_IN, H, W)
    bg_in = {"seg": rep["seg"].reshape(1, T_IN, H, W),
             "depth": rep_depth.clamp(min=0.0), "depth_mask": rep_depth > 0}
    ms = {
        "step_device_inputs": time_ms(lambda: step(pc_dev, fg_dev), 10, 2),
        "pc": time_ms(pc_stage, 10, 2),
        "bg": time_ms(lambda: bg(bg_in, return_argmax=True), 10, 2),
        "fg": time_ms(lambda: fg(fg_flat, OUT_T), 10, 2),
    }
    ms["fusion_and_rest"] = ms["step_device_inputs"] - ms["pc"] - ms["bg"] - ms["fg"]
    print("[stages] " + json.dumps({k: round(v, 4) for k, v in ms.items()}))

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(pc_dev, fg_dev)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy > 0:
        # busy time from the profiler, step time from CUDA events (unprofiled)
        per_step = ms["step_device_inputs"]
        print(f"[profile] one step: device busy {busy:.2f} ms (profiler) of "
              f"{per_step:.2f} ms per step (CUDA events): idle share "
              f"{1 - busy / per_step:.3f}")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
                  f"x{e.count:<4d} {e.key[:90]}")
    else:
        print("[profile] device time: not measured (profiler saw no kernels)")
    print(f"[memory] peak allocated during a step: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def check_output(out, height: int, width: int):
    pan = out["panoptic"]
    assert pan.shape == (1, height, width) and pan.dtype == torch.int32, pan.shape
    ids = out["ids"][0]
    bg = out["bg_seg"]
    assert bg.shape == (1, height, width)
    assert int(bg.min()) >= 0 and int(bg.max()) < 11
    assert torch.isfinite(out["bg_depth"]).all() and torch.isfinite(out["bbox"]).all()
    allowed = set(range(11)) | {255} | set(ids[ids > 0].tolist())
    assert set(torch.unique(pan).tolist()) <= allowed
    nz = ids[ids > 0].tolist()
    assert len(nz) == len(set(nz)) and all(11 <= v // 1000 <= 18 for v in nz)
    return float((pan >= 11000).float().mean())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    # The JAX reference computes in full f32; cuDNN would default to TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    t0 = time.perf_counter()

    # ---- 1. build -----------------------------------------------------------
    secs = build.build(["placement", "stem"], verbose=True)
    print("[build] " + ", ".join(f"{k}.cu {v:.1f}s" for k, v in secs.items()))

    bg, fg = make_models(dev)
    pc_in, fg_in = make_inputs(H, W)

    # ---- 2. K1 against its plain version ------------------------------------
    group, key, num_groups = k1_inputs(pc_in, dev)
    k1 = place_min(group, key, num_groups)
    k1_ref = place_min_plain(group, key, num_groups)
    torch.cuda.synchronize()
    k1_err = int((k1.long() - k1_ref.long()).abs().max())
    if not torch.equal(k1, k1_ref):
        raise SystemExit(f"K1 differs from its plain version: {k1_err}")
    print(f"[K1] place_min {group.numel()} entries -> {num_groups} groups: "
          f"bit-equal, {int((k1 != EMPTY).sum())} groups touched")

    edge_cases(dev)

    # ---- 3. K2 against its plain version ------------------------------------
    seg, dep, kern, bias = k2_inputs(bg, pc_in, dev)
    k2 = onehot_stem_conv(seg, dep, kern, bias, num_classes=11)
    k2_ref = onehot_stem_conv_plain(seg, dep, kern, bias, num_classes=11)
    torch.cuda.synchronize()
    k2_err = float((k2 - k2_ref).abs().max())
    print(f"[K2] onehot_stem_conv {tuple(seg.shape)} -> {tuple(k2.shape)}: "
          f"max abs diff {k2_err:.3e} (limit 1e-5: f32 sums in another order)")
    if not k2_err <= 1e-5:
        raise SystemExit(f"K2 differs from its plain version by {k2_err}")

    # ---- 4. the main path, counted ------------------------------------------
    step = build_forecast_step(bg, fg, height=H, width=W, out_t=OUT_T)
    place_min.launches = 0
    onehot_stem_conv.launches = 0
    out = step(pc_in, fg_in)
    torch.cuda.synchronize()
    launches = {"place_min": place_min.launches,
                "onehot_stem_conv": onehot_stem_conv.launches}
    print(f"[step] {H}x{W}: launches {launches}")
    if min(launches.values()) < 1:
        raise SystemExit(f"a kernel of the main path did not launch: {launches}")
    painted = check_output(out, H, W)
    print(f"[step] panoptic {tuple(out['panoptic'].shape)}, ids "
          f"{out['ids'][0].tolist()}, {painted:.3f} of pixels in instances")

    # ---- 5. GPU against CPU at 256x512 ---------------------------------------
    pc_s, fg_s = make_inputs(H_SMALL, W_SMALL)
    outs = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        bg_d, fg_d = make_models(d, H_SMALL, W_SMALL)
        outs[name] = build_forecast_step(
            bg_d, fg_d, height=H_SMALL, width=W_SMALL, out_t=OUT_T, device=d,
        )(pc_s, fg_s)
    ids_g, ids_c = outs["cuda"]["ids"].cpu(), outs["cpu"]["ids"]
    pan_mis = float((outs["cuda"]["panoptic"].cpu() != outs["cpu"]["panoptic"])
                    .float().mean())
    bg_mis = float((outs["cuda"]["bg_seg"].cpu() != outs["cpu"]["bg_seg"])
                   .float().mean())
    print(f"[gpu-vs-cpu] {H_SMALL}x{W_SMALL}: ids {ids_g.tolist()} vs "
          f"{ids_c.tolist()}, panoptic mismatch {pan_mis:.3e}, bg mismatch "
          f"{bg_mis:.3e}")
    if not torch.equal(ids_g, ids_c) or not pan_mis < 1e-3:
        raise SystemExit("GPU and CPU steps disagree")
    check_output(outs["cuda"], H_SMALL, W_SMALL)

    # ---- 6. timings ----------------------------------------------------------
    g64 = group.long()
    filled = torch.full((num_groups,), EMPTY, dtype=torch.int32, device=dev)
    x_onehot = torch.cat([assemble_onehot(seg, 11), dep], 1)
    w_oihw = kern.permute(3, 2, 0, 1).contiguous()
    times = {
        "k1": time_ms(lambda: place_min(group, key, num_groups)),
        "k1_plain": time_ms(lambda: place_min_plain(group, key, num_groups)),
        "k1_lib": time_ms(lambda: torch.scatter_reduce(filled, 0, g64, key, "amin")),
        "k2": time_ms(lambda: onehot_stem_conv(seg, dep, kern, bias, num_classes=11)),
        "k2_plain": time_ms(lambda: onehot_stem_conv_plain(seg, dep, kern, bias,
                                                           num_classes=11)),
        "k2_lib": time_ms(lambda: F.conv2d(x_onehot, w_oihw, bias, stride=2, padding=1)),
    }
    step_ms = []
    for i in range(7):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        step(pc_in, fg_in)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
    step_ms = sorted(step_ms[2:])
    print(f"[time] step {H}x{W} host clock (inputs from host numpy): median "
          f"{step_ms[len(step_ms) // 2]:.2f} ms, min {step_ms[0]:.2f} ms")
    stage_breakdown(step, bg, fg, pc_in, fg_in, dev)
    for k, v in times.items():
        print(f"[time] {k} {v:.4f} ms")

    n, g = group.numel(), num_groups
    k1_bound, k1_by = bound_ms(4 * n * 2 + 4 * g, n)
    k2_bytes = (seg.numel() * 4 + dep.numel() * 4 + kern.numel() * 4
                + bias.numel() * 4 + k2.numel() * 4)
    k2_bound, k2_by = bound_ms(k2_bytes, k2_flops(seg, 11))
    kernels = [
        {"name": "place_min", "route": "cuda",
         "source": "panoptic_forecasting_tpu_torch/csrc/placement.cu",
         "replaces": "panoptic_forecasting_tpu/kernels/placement.py:197",
         "launches": launches["place_min"], "max_abs_err": k1_err,
         "ms": times["k1"], "plain_ms": times["k1_plain"],
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": times["k1_lib"]},
        {"name": "onehot_stem_conv", "route": "cuda",
         "source": "panoptic_forecasting_tpu_torch/csrc/stem.cu",
         "replaces": "panoptic_forecasting_tpu/kernels/stem.py:180",
         "launches": launches["onehot_stem_conv"], "max_abs_err": k2_err,
         "ms": times["k2"], "plain_ms": times["k2_plain"],
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": times["k2_lib"]},
    ]
    print(f"[total] {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
