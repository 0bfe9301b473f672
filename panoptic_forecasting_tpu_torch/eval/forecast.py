"""Single-call panoptic forecast: pc -> bg -> fg -> fusion.

Counterpart of ``panoptic_forecasting_tpu/eval/forecast.py``. Per target
frame the step:

  1. reprojects each past frame's segmentation into the target camera
     with the packed z-buffer splat (K1 on the GPU);
  2. runs FCHarDNet-70 over the one-hot + depth stack and takes the
     argmax (K2 computes the fused stem on the folded model; a bf16
     model's K2 writes bf16, and the argmax is taken on f32 logits);
  3. rolls the foreground GRU + ConvLSTM forward, runs the mask head and
     picks each instance's box and depth (``eval/fusion.py``: boxes
     converted cwh -> ulbr unless the fg model forecasts ulbr boxes, the
     depth the column after the box state);
  4. fuses the B scenes through ``eval/fusion.py`` in one call: the
     instances ordered far to near with per-class visit-order ids
     ((class + 11)·1000 + rank), pasted and composited over the
     background, thing pixels of which become 255.

The inputs reach the device through ``eval/inputs.py``: on a CUDA device
each host input is copied once into its own pinned tensor and moved by
its own copy, each pc map's DMA overlapping the next map's host pass,
the fg and fusion inputs staged after bg is launched.

While a ``torch.profiler`` records, a call is the span ``pf.forecast``
and its stages the spans ``pf.forecast.pc``, ``.bg``, ``.fg`` and
``.fusion`` (``core/tracing.py``); each input's copy to the device is
launched in the stage that reads it, its host pass in the span
``pf.forecast.stage`` inside that stage.

Reference capability: the chained scripts of
``scripts/fg/run_fg_eval_panoptic.sh`` (pc export -> bg export ->
panoptic export), here one call with no host round trip between stages.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..core.tracing import span
from ..device import DeviceLike, resolve_device
from ..models.pc_transform import pc_transform_predict
from .fusion import N_STUFF, _pred_boxes_depths, composite, visit_order
from .inputs import Inputs


def build_forecast_step(bg_model, fg_model, *, height: int, width: int,
                        out_t: int, threshold: float = 0.5,
                        use_bg_depth: bool = False,
                        device: DeviceLike = None) -> Callable:
    """Returns ``step(pc_in, fg_in) -> dict`` on ``device`` (the GPU unless
    ``device="cpu"``; raises when CUDA is absent and the CPU was not asked
    for). The models must already live on that device.

    pc_in: seg/depth/depth_mask (B, T, H, W), intrinsics (B, 3, 3),
      extrinsics (B, 4, 4), target_T (B, T, 4, 4).
    fg_in: the dense padded fg-scene inputs (trajectories, bbox_masks,
      bbox_vel_masks, depths, depth_masks, feats, odometry, classes,
      output_inds, valid) with leading (B, N). numpy arrays or tensors; a
      tensor already on the step's device is read where it lies.

    The result holds ``panoptic`` (B, H, W) int32 trainId·1000+inst maps,
    ``bg_seg``, ``bg_depth``, and ``ids``/``bbox``/``depths`` indexed by
    ORIGINAL instance slot (ids[b, k] is input instance k's painted id,
    0 for padded slots). ``use_bg_depth`` z-buffers instances against the
    reprojected depth; by default (as in the reference's shipped data)
    instances always paint over the background.

    ``step.counters`` counts the calls and how their inputs reached the
    device (``eval/inputs.py::Inputs``).
    """
    dev = resolve_device(device)
    for name, model in (("bg_model", bg_model), ("fg_model", fg_model)):
        p = next(model.parameters())
        if p.device.type != dev.type:
            raise ValueError(f"{name} lives on {p.device}, the step on {dev}")

    inputs = Inputs(dev)

    @torch.no_grad()
    def step(pc_in: Dict[str, Any], fg_in: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        with span("forecast"):
            return staged(pc_in, fg_in)

    def staged(pc_in, fg_in):
        f32 = torch.float32

        # ---- 1. per-frame reprojection (reference ind0/1/2 exports) -----
        with span("forecast.pc"):
            seg, depth, depth_mask = inputs.pc(pc_in)
            b, t = seg.shape[:2]

            def flat(x):
                return x.reshape((b * t, 1) + tuple(x.shape[2:]))

            # The camera matrices stay where the caller has them: the 4x4
            # chain is computed on the host.
            def cam(x):
                return torch.as_tensor(x, dtype=f32).repeat_interleave(t, 0)

            rep = pc_transform_predict(
                flat(seg), flat(depth), flat(depth_mask),
                cam(pc_in["intrinsics"]), cam(pc_in["extrinsics"]),
                torch.as_tensor(pc_in["target_T"], dtype=f32).reshape(b * t, 1, 4, 4),
                height=height, width=width, device=dev,
            )
            rep_seg = rep["seg"].reshape(b, t, height, width)
            rep_depth = rep["depth"].reshape(b, t, height, width)

        # ---- 2. background ----------------------------------------------
        with span("forecast.bg"):
            bg_seg = bg_model(
                {"seg": rep_seg, "depth": rep_depth.clamp(min=0.0),
                 "depth_mask": rep_depth > 0},
                return_argmax=True,
            )
            # Combined z-buffer depth over the input frames; empty -> 1e9
            # so instances always paint there (fusion strict-< rule).
            inf = torch.full_like(rep_depth, float("inf"))
            bg_depth = torch.where(rep_depth > 0, rep_depth, inf).amin(1)
            bg_depth = torch.where(torch.isfinite(bg_depth), bg_depth, 1e9)

        # ---- 3. foreground rollout --------------------------------------
        with span("forecast.fg"):
            fg_dev = inputs.fg(fg_in)
            n = fg_dev["trajectories"].shape[1]
            flat_in = {k: v.reshape((b * n,) + tuple(v.shape[2:]))
                       for k, v in fg_dev.items() if k != "valid"}
            preds = {k: v.reshape((b, n) + tuple(v.shape[1:]))
                     for k, v in fg_model(flat_in, out_t).items()}
            boxes, inst_depth = _pred_boxes_depths(fg_model, preds, fg_dev["output_inds"],
                                                   out_t)
            masks = torch.sigmoid(preds["masks"])

        # ---- 4. fusion ---------------------------------------------------
        with span("forecast.fusion"):
            classes = fg_dev["classes"].reshape(b, n).long()
            valid = fg_dev["valid"].reshape(b, n).bool()
            canvas = torch.where(bg_seg >= N_STUFF, 255, bg_seg).to(torch.int32)
            sort = fg_model.use_depth_sorting
            order, ids = visit_order(inst_depth, classes, valid, use_depth_sorting=sort)
            pan, ids = composite(masks, boxes, inst_depth, valid, order, ids, canvas,
                                 bg_depth if use_bg_depth else None,
                                 use_depth_sorting=sort, threshold=threshold)
            return {
                "panoptic": pan,
                "ids": ids,
                "bg_seg": bg_seg,
                "bg_depth": bg_depth,
                "bbox": boxes,
                "depths": inst_depth,
            }

    step.counters = inputs.counters
    return step
