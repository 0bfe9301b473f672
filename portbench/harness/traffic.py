"""The one traffic generator: street-like scenes drawn from a seed.

A traffic file (``portbench/traffic/<mix>.json``) holds only parameters;
its ``kind`` picks what is made of them:

* ``scenes``: a pool of forecast inputs, one camera at batch 1: three
  past frames of a street (stuff regions with ragged borders, depth from
  a ground plane and facades, sky invalid, Cityscapes' camera, ego
  speed and yaw rate) and the instance slots of the fg model (cars and
  people standing on the ground, boxes sized by their depth);
* ``crops``: a pool of bg training batches in the train loader's format
  (reprojected trainId segs uint8, raw uint16 depth, GT with things
  255), each crop a street rendered at a scale and offset, i.e. after
  ``RandomScaleCrop`` and the flip;
* ``files``: full-size frames of the bg train split, one at a time, for
  the loader's files (``portbench/harness/fixture.py`` writes them): the
  same three segs, raw depth block and GT, before any crop or flip.

A kind not among these is found by name: ``make(params, cfg, seed, dev)``
of ``portbench/harness/traffic_<kind>.py``.

Everything is drawn on the device from one ``torch.Generator`` and then
held on the host as numpy, as a loader hands it over. The set of sizes
(valid slots a scene, crop scales) is fixed by the traffic file and only
its order depends on the seed, so every seed gives the same work.
"""

from __future__ import annotations

import importlib
import math
from typing import Any, Dict, List

import numpy as np
import torch

# Cityscapes trainIds of the stuff classes (the bg model's 11 classes)
ROAD, SIDEWALK, BUILDING, WALL, FENCE, POLE, LIGHT, SIGN, VEGETATION, TERRAIN, SKY = range(11)
# the fg model's 8 thing classes, in trainId order from 11
THINGS = ("person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle")
# (height, width) in metres of each thing class's box
THING_SIZE = {"person": (1.7, 0.6), "rider": (1.8, 0.8), "car": (1.5, 3.0),
              "truck": (3.0, 4.0), "bus": (3.2, 6.0), "train": (3.8, 8.0),
              "motorcycle": (1.4, 1.0), "bicycle": (1.3, 1.0)}
CAM_HEIGHT = 1.22  # m, Cityscapes' camera above the ground
CAM_X, CAM_PITCH = 1.7, 0.038  # m ahead of the rear axle; rad


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one use of a run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (2**63 - 1))
    return g


def _u(g, n, lo, hi, dev):
    return torch.rand(n, generator=g, device=dev) * (hi - lo) + lo


def _walk(g, n, step, dev):
    """A ragged 1-D profile: a random walk of ``n`` steps, mean 0."""
    x = torch.cumsum(torch.randn(n, generator=g, device=dev) * step, 0)
    return x - x.mean()


def intrinsics(cam: Dict[str, Any], scale: float = 1.0, du: float = 0.0,
               dv: float = 0.0) -> np.ndarray:
    fx, fy, cx, cy = (float(x) for x in cam["intrinsics"])
    return np.array([[fx * scale, 0, cx * scale - du],
                     [0, fy * scale, cy * scale - dv], [0, 0, 1]], np.float32)


def extrinsics() -> np.ndarray:
    """vehicle_T_camera of an RDF camera CAM_X ahead, CAM_HEIGHT up,
    pitched down by CAM_PITCH (the Cityscapes calibration's form)."""
    sp, cp = math.sin(CAM_PITCH), math.cos(CAM_PITCH)
    v_T_flu = np.eye(4)
    v_T_flu[:3, :3] = [[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]]
    v_T_flu[:3, 3] = [CAM_X, 0.0, CAM_HEIGHT]
    flu_T_rdf = np.eye(4)
    flu_T_rdf[:3, :3] = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]
    return (v_T_flu @ flu_T_rdf).astype(np.float32)


def now_T_prev(speed: float, yaw_rate: float, dt: float) -> np.ndarray:
    """4x4 motion of a unicycle over ``dt``: the earlier vehicle frame's
    points in the later one's coordinates."""
    if abs(yaw_rate) < 1e-9:
        x, y, th = dt * speed, 0.0, 0.0
    else:
        r, th = speed / yaw_rate, yaw_rate * dt
        x, y = r * math.sin(th), r * (1 - math.cos(th))
    c, s = math.cos(th), math.sin(th)
    T = np.eye(4)
    T[:2, :2] = [[c, s], [-s, c]]
    T[0, 3] = -(c * x + s * y)
    T[1, 3] = -(-s * x + c * y)
    return T


def street(g, h: int, w: int, K: np.ndarray, max_depth: float, dev,
           flip: bool = False):
    """One street view: (label (h, w) int64, depth (h, w) f32 with 0 where
    invalid, ground (h, w) bool). A canyon of facades at a lateral offset
    on each side, closed far ahead; road, sidewalks and terrain on the
    ground plane; poles with signs and lights along the kerb; sky above
    a ragged skyline."""
    fx, fy, cx, cy = float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])
    u = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    v = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    vh = cy + float(_u(g, 1, -8, 8, dev))
    road = float(_u(g, 1, 3.0, 7.0, dev))  # half width, m
    walk_w = float(_u(g, 1, 1.5, 4.0, dev))
    end = float(_u(g, 1, 80.0, max_depth, dev))  # the street's far end, m

    # facades: segments along the columns, each with its setback, class
    # and height; depth of a column from its side's facade plane
    nseg = 14
    cuts = torch.sort(_u(g, nseg - 1, 0, w, dev))[0]
    seg = torch.bucketize(u[0], cuts)
    setback = _u(g, nseg, 0.5, 6.0, dev)[seg] + road + walk_w
    cls_draw = torch.rand(nseg, generator=g, device=dev)
    fac_cls = torch.where(cls_draw < 0.6, BUILDING, torch.where(
        cls_draw < 0.85, VEGETATION, torch.where(cls_draw < 0.95, WALL, FENCE)))[seg]
    height = _u(g, nseg, 4.0, 30.0, dev)[seg]
    height = torch.where(fac_cls == FENCE, torch.full_like(height, 1.2), height)
    side = (u[0] - cx).abs().clamp(min=1.0)
    z_col = torch.clamp(setback * fx / side, max=end)
    top = vh - fy * (height - CAM_HEIGHT) / z_col + _walk(g, w, 1.2, dev)
    foot = vh + fy * CAM_HEIGHT / z_col

    # ground plane below the facades' feet
    dv = (v - vh).clamp(min=0.5)
    z_ground = fy * CAM_HEIGHT / dv
    lateral = (u - cx) * z_ground / fx
    edge = _walk(g, h, 0.02, dev)[:, None]  # ragged kerbs, m
    gcls = torch.where(lateral.abs() < road + edge, ROAD, torch.where(
        lateral.abs() < road + walk_w + edge, SIDEWALK, TERRAIN))
    is_ground = v >= foot[None, :]
    is_sky = v < top[None, :]
    label = torch.where(is_sky, SKY, torch.where(is_ground, gcls, fac_cls[None, :]))
    depth = torch.where(is_ground, z_ground, z_col[None, :].expand(h, w))

    # poles along the kerbs, a sign or a light on top
    for _ in range(10):
        zp = float(_u(g, 1, 6.0, 60.0, dev))
        xp = (road + 0.4) * (1 if float(_u(g, 1, 0, 1, dev)) < 0.5 else -1)
        up = cx + xp * fx / zp
        half = max(1.0, 0.12 * fx / zp)
        bottom, top_p = vh + fy * CAM_HEIGHT / zp, vh - fy * (4.5 - CAM_HEIGHT) / zp
        pole = ((u - up).abs() <= half) & (v >= top_p) & (v < bottom)
        head = ((u - up).abs() <= 3 * half) & (v >= top_p - 6 * half) & (v < top_p)
        label = torch.where(pole, POLE, label)
        label = torch.where(head, SIGN if float(_u(g, 1, 0, 1, dev)) < 0.6 else LIGHT, label)
        depth = torch.where(pole | head, torch.full_like(depth, zp), depth)

    depth = depth * (1 + 0.004 * torch.randn((h, w), generator=g, device=dev))
    depth = torch.where(label == SKY, 0.0, depth.clamp(max=max_depth))
    if flip:
        label, depth, is_ground = (x.flip(-1) for x in (label, depth, is_ground))
    return label, depth.to(torch.float32), is_ground


def _instances(g, n: int, n_valid: int, params, K, t_in: int, t_all: int,
               speed: float, yaw_rate: float, feat: tuple, dev):
    """The fg model's inputs for ``n`` slots, the first ``n_valid`` of them
    objects on the ground plane (classes by the traffic's weights)."""
    fx, fy, cx, cy = float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])
    weights = torch.tensor([float(params["classes"].get(c, 0.0)) for c in THINGS],
                           device=dev)
    cls = torch.multinomial(weights / weights.sum(), n, replacement=True, generator=g)
    size = torch.tensor([THING_SIZE[c] for c in THINGS], device=dev)[cls]
    z = _u(g, n, 6.0, 50.0, dev)
    on_road = (cls >= 2) & (cls <= 5)
    lateral = torch.where(on_road, _u(g, n, -5.0, 5.0, dev),
                          _u(g, n, 4.0, 8.0, dev) * torch.sign(_u(g, n, -1, 1, dev)))
    bw, bh = fx * size[:, 1] / z, fy * size[:, 0] / z
    bottom = cy + fy * CAM_HEIGHT / z
    box0 = torch.stack([cx + lateral * fx / z, bottom - bh / 2, bw, bh], -1)
    vel = torch.randn((n, 4), generator=g, device=dev) * torch.tensor(
        [4.0, 1.0, 0.5, 0.5], device=dev)
    t = torch.arange(t_in, device=dev, dtype=torch.float32)[None, :, None]
    traj = torch.cat([box0[:, None] + t * vel[:, None],
                      vel[:, None].expand(n, t_in, 4) * (t > 0)], -1)
    dz = torch.randn(n, generator=g, device=dev) * 0.3
    depths = torch.stack([z[:, None] + t[..., 0] * dz[:, None],
                          dz[:, None].expand(n, t_in)], -1)
    feats = torch.relu(torch.randn((n, t_in) + feat, generator=g, device=dev))
    odom = torch.zeros((n, t_all, 5), device=dev)
    odom[..., 0] = speed + 0.1 * torch.randn((n, t_all), generator=g, device=dev)
    odom[..., 1] = yaw_rate
    odom[..., 2] = 0.5
    valid = torch.arange(n, device=dev) < n_valid
    vmask = valid[:, None].expand(n, t_all)
    vel_mask = vmask.clone()
    vel_mask[:, 0] = False
    zero = lambda x: torch.where(valid.view((n,) + (1,) * (x.dim() - 1)), x, 0)  # noqa: E731
    out = {
        "trajectories": zero(traj), "bbox_masks": vmask, "bbox_vel_masks": vel_mask,
        "depths": zero(depths), "depth_masks": vmask[:, :t_in, None],
        "feats": zero(feats), "odometry": odom, "classes": zero(cls),
        "output_inds": torch.full((n,), t_all - t_in - 1, device=dev),
        "valid": valid,
    }
    return {k: x.cpu().numpy()[None] for k, x in out.items()}


def scenes(params: Dict[str, Any], cfg: Dict[str, Any], seed: int, dev) -> List[Dict]:
    """The ``scenes`` pool: a list of (pc_in, fg_in) numpy dicts at batch 1."""
    g = generator(seed, 1, dev)
    h, w, t_in, out_t = cfg["height"], cfg["width"], cfg["num_inputs"], cfg["out_t"]
    cam = cfg["camera"]
    m = cfg["fg"]["model"]
    c, hw = int(m.get("mask_feat_channels", 256)), int(m.get("mask_feat_hw", 14))
    K = intrinsics(cam, w / 2048.0)
    E = extrinsics()
    dt = float(params["frame_gap"]) / float(cam["fps"])
    pool = int(params["pool"])
    lo, hi = params["valid_slots"]
    counts = np.linspace(lo, hi, pool).round().astype(int)
    order = torch.randperm(pool, generator=g, device=dev).cpu().numpy()
    out = []
    for i in range(pool):
        speed = float(_u(g, 1, *params["speed"], dev))
        yaw = float(_u(g, 1, *params["yaw_rate"], dev))
        label, depth, ground = street(g, h, w, K, float(cfg["max_depth"]), dev)
        segs, depths = [], []
        for k in range(t_in):  # older frames see the facades farther away
            shift = speed * dt * (t_in - 1 - k)
            segs.append(label)
            depths.append(torch.where(ground | (depth == 0), depth, depth + shift))
        depth_t = torch.stack(depths)[None]
        target = np.stack([now_T_prev(speed, yaw, dt * (t_in - 1 - k + out_t))
                           for k in range(t_in)]).astype(np.float32)
        pc_in = {
            "seg": torch.stack(segs)[None].to(torch.int32).cpu().numpy(),
            "depth": depth_t.cpu().numpy(),
            "depth_mask": (depth_t > 0).cpu().numpy(),
            "intrinsics": K[None], "extrinsics": E[None], "target_T": target[None],
        }
        fg_in = _instances(g, int(params["slots"]), int(counts[order[i]]), params,
                           K, t_in, t_in + out_t, speed, yaw, (c, hw, hw), dev)
        out.append((pc_in, fg_in))
    return out


def crops(params: Dict[str, Any], cfg: Dict[str, Any], seed: int, dev) -> List[Dict]:
    """The ``crops`` pool: ``pool`` batches of ``batch`` crops, each a
    street at a scale from the traffic's range, cut at a random offset
    and flipped half the time, in the bg train loader's batch format."""
    g = generator(seed, 2, dev)
    size = int(cfg["data"]["crop_size"])
    t_in = int(cfg["model"]["num_inputs"])
    max_depth = float(cfg["data"]["max_depth"])
    cam = params["camera"]
    pool, batch = int(params["pool"]), int(params["batch"])
    lo, hi = params["scale"]
    scales = np.linspace(lo, hi, pool * batch)[
        torch.randperm(pool * batch, generator=g, device=dev).cpu().numpy()]
    out = []
    for b in range(pool):
        segs, deps, gts = [], [], []
        for j in range(batch):
            s = float(scales[b * batch + j])
            du = float(_u(g, 1, 0, max(0.0, 2048 * s - size), dev))
            dv = float(_u(g, 1, 0, max(0.0, 1024 * s - size), dev))
            K = intrinsics(cam, s, du, dv)
            flip = float(_u(g, 1, 0, 1, dev)) < 0.5
            label, depth, _ = street(g, size, size, K, max_depth, dev, flip)
            gt = label.clone()
            for _ in range(6):  # things are 255 in the GT (only_background)
                x0, y0 = (int(_u(g, 1, 0, size - 40, dev)) for _ in range(2))
                bw, bh = (int(_u(g, 1, 20, 200, dev)) for _ in range(2))
                gt[y0:y0 + bh, x0:x0 + bw] = 255
            frames = [torch.roll(label, int(k * 3), -1) for k in range(t_in - 1, -1, -1)]
            raw = torch.where(depth > 0, (depth + 1) * 256, 0).round()
            segs.append(torch.stack(frames).to(torch.uint8))
            deps.append(torch.stack([torch.roll(raw, int(k * 3), -1)
                                     for k in range(t_in - 1, -1, -1)]).to(torch.int32))
            gts.append(gt.to(torch.int32))
        out.append({
            "inputs": {"seg": torch.stack(segs).cpu().numpy(),
                       "depth": torch.stack(deps).cpu().numpy().astype(np.uint16)},
            "labels": {"seg": torch.stack(gts).cpu().numpy()},
        })
    return out


def files(params: Dict[str, Any], cfg: Dict[str, Any], seed: int, dev):
    """The ``files`` mix: ``samples`` frames at the traffic's ``size``,
    yielded one at a time as host numpy {"name": (city, seq, frame),
    "segs" (T, H, W) uint8, "depth" (H, W, T) uint16 raw, "gt" (H, W)
    uint8}; the cities take the frames in turn."""
    g = generator(seed, 3, dev)
    h, w = params["size"]
    t_in = int(cfg["model"]["num_inputs"])
    max_depth = float(cfg["data"]["max_depth"])
    K = intrinsics(params["camera"], w / 2048.0)
    cities = params["cities"]
    for n in range(int(params["samples"])):
        label, depth, _ = street(g, h, w, K, max_depth, dev)
        gt = label.clone()
        for _ in range(6):  # things are 255 in the GT (only_background)
            x0, y0 = int(_u(g, 1, 0, w - 80, dev)), int(_u(g, 1, 0, h - 80, dev))
            bw, bh = (int(_u(g, 1, 40, 400, dev)) for _ in range(2))
            gt[y0:y0 + bh, x0:x0 + bw] = 255
        raw = torch.where(depth > 0, (depth + 1) * 256, 0).round()
        shifts = [int(k * 3) for k in range(t_in - 1, -1, -1)]
        yield {"name": (cities[n % len(cities)], n // len(cities), 19),
               "segs": torch.stack([torch.roll(label, k, -1) for k in shifts])
               .to(torch.uint8).cpu().numpy(),
               "depth": torch.stack([torch.roll(raw, k, -1) for k in shifts], -1)
               .to(torch.int32).cpu().numpy().astype(np.uint16),
               "gt": gt.to(torch.uint8).cpu().numpy()}


KINDS = {"scenes": scenes, "crops": crops, "files": files}


def make(params: Dict[str, Any], cfg: Dict[str, Any], seed: int, dev):
    """The pool a traffic file describes, for a run's seed."""
    kind = params["kind"]
    make_kind = KINDS.get(kind) or importlib.import_module(
        f"portbench.harness.traffic_{kind}").make
    return make_kind(params, cfg, seed, dev)
