"""Single-call panoptic forecast: pc -> bg -> fg -> fusion.

Counterpart of ``panoptic_forecasting_tpu/eval/forecast.py``. Per target
frame the step:

  1. reprojects each past frame's segmentation into the target camera
     with the packed z-buffer splat (K1 on the GPU);
  2. runs FCHarDNet-70 over the one-hot + depth stack and takes the
     argmax (K2 computes the fused stem on the folded model; a bf16
     model's K2 writes bf16, and the argmax is taken on f32 logits);
  3. rolls the foreground GRU + ConvLSTM forward and runs the mask head;
  4. orders the instances far to near, assigns per-class visit-order ids
     ((class + 11)·1000 + rank), and pastes and composites them over the
     background. Boxes are converted cwh -> ulbr unless the fg model
     forecasts ulbr boxes (``use_bbox_ulbr``); the instance depth is the
     column after the box state (4 under ``only_loc_feats``, else 8).

The inputs reach the device through ``eval/inputs.py``: on a CUDA device
each host input is copied once into pinned memory, each pc map's DMA
overlapping the next map's host pass, the fg and fusion inputs packed in
one copy issued after bg is launched.

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
from ..geometry.boxes import bbox_cwh_to_ulbr
from ..kernels.mask_paste import paste_and_composite
from ..models.pc_transform import pc_transform_predict
from .inputs import Inputs

N_STUFF = 11  # bg classes >= 11 are things: they become 255 in the canvas


def _instance_ids(classes, depths, valid, use_depth_sorting: bool):
    """Paint order + panoptic ids for one scene: far-to-near stable order,
    id = (class + 11)·1000 + per-class visit rank; padded slots get 0."""
    n = classes.shape[0]
    if use_depth_sorting:
        key = torch.where(valid, -depths, torch.full_like(depths, float("inf")))
        order = torch.argsort(key, stable=True)
    else:
        order = torch.arange(n, device=classes.device)
    cls_s = classes[order]
    val_s = valid[order]
    idx = torch.arange(n, device=classes.device)
    earlier_same = (
        (cls_s[None, :] == cls_s[:, None])
        & (idx[None, :] < idx[:, None])
        & val_s[None, :]
    )
    rank = earlier_same.sum(1)
    ids = torch.where(val_s, (cls_s + N_STUFF) * 1000 + rank, 0).to(torch.int32)
    return order, ids


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
            preds = fg_model(flat_in, out_t)
            traj = preds["unnormalized_trajectory"][:, -out_t:]
            oidx = flat_in["output_inds"].long()
            sel = traj[torch.arange(b * n, device=dev), oidx]
            boxes = sel[..., :4]
            if not fg_model.use_bbox_ulbr:
                boxes = bbox_cwh_to_ulbr(boxes)
            inst_depth = (sel[..., fg_model.traj_dim] if fg_model.use_depth_inp
                          else sel.new_zeros(sel.shape[:1]))
            masks = torch.sigmoid(preds["masks"])
            mh = masks.shape[-1]
            masks = masks.reshape(b, n, mh, mh)
            boxes = boxes.reshape(b, n, 4).to(f32)
            inst_depth = inst_depth.reshape(b, n).to(f32)

        # ---- 4. fusion ---------------------------------------------------
        with span("forecast.fusion"):
            classes = fg_dev["classes"].reshape(b, n).long()
            valid = fg_dev["valid"].reshape(b, n).bool()
            canvas = torch.where(bg_seg >= N_STUFF, 255, bg_seg).to(torch.int32)
            fusion_depth = bg_depth if use_bg_depth else torch.full_like(bg_depth, 1e9)
            pans, ids_all = [], []
            for i in range(b):
                order, ids = _instance_ids(
                    classes[i], inst_depth[i], valid[i], fg_model.use_depth_sorting
                )
                pan, _ = paste_and_composite(
                    masks[i][order], boxes[i][order], inst_depth[i][order], ids,
                    valid[i][order], canvas[i], fusion_depth[i],
                    img_h=height, img_w=width, threshold=threshold,
                    use_depth=fg_model.use_depth_sorting and use_bg_depth,
                )
                # ids back to ORIGINAL slot order, pairing with bbox/depths.
                ids_slot = torch.zeros_like(ids)
                ids_slot[order] = ids
                pans.append(pan)
                ids_all.append(ids_slot)
            return {
                "panoptic": torch.stack(pans),
                "ids": torch.stack(ids_all),
                "bg_seg": bg_seg,
                "bg_depth": bg_depth,
                "bbox": boxes,
                "depths": inst_depth,
            }

    step.counters = inputs.counters
    return step
