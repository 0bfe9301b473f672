"""Panoptic / semantic / instance fusion of fg forecasts over bg canvases.

Counterpart of ``panoptic_forecasting_tpu/eval/fusion.py`` (reference
``FGModel.predict_semantics`` / ``predict_panoptic`` /
``predict_instances``, fg_model.py:389-746): forward the scenes'
instances, sigmoid the mask logits, paste each 28×28 mask at its
predicted box, threshold at 0.5 and composite far to near (descending
predicted depth) over the background canvas.

The visit order and the ids are one batched device function,
``visit_order``: far to near (a stable ``argsort`` of ``-depth``, padded
slots last), and panoptic ids ``(class+11)·1000 + k`` with ``k`` the
instance's rank among the valid instances of its class in visit order.
``composite`` pastes and composites S scenes in that order in one call
(``kernels/mask_paste.py::paste_and_composite_scenes``). The forecast
step (``eval/forecast.py``) and the staged exports below both fuse
through these two. Thing pixels (>= 11) of the canvas become 255 before
the composite. With a background depth map the composite z-buffers
against it (strict ``<``, unknown depth 1e9, and a
``background_depth_mask`` turns masked pixels unknown); otherwise later
(nearer) instances overwrite.

The model carries its weights, so the JAX functions' ``variables``
argument has no counterpart.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..geometry.boxes import bbox_cwh_to_ulbr
from ..kernels.mask_paste import paste_and_composite_scenes

IMG_H, IMG_W = 1024, 2048
N_STUFF = 11  # bg classes >= 11 are things: they become 255 in the panoptic canvas
# batch inputs that are not per-instance model inputs
NOT_MODEL_INPUTS = ("background", "background_depth", "background_depth_mask",
                    "valid", "inst_scores")


def run_scene_forward(model, batch) -> Dict[str, torch.Tensor]:
    """Forward all scenes' padded instances in one call; the outputs get
    their leading (S, N) shape back."""
    inputs = batch["inputs"]
    s, n = np.asarray(inputs["trajectories"]).shape[:2]
    flat = {}
    for k, v in inputs.items():
        if k not in NOT_MODEL_INPUTS:
            v = np.asarray(v)
            flat[k] = v.reshape((-1,) + v.shape[2:])
    flat["output_inds"] = np.asarray(batch["labels"]["output_inds"]).reshape(-1)
    out_t = int(np.asarray(batch["labels"]["trajectories"]).shape[2])
    preds = model(flat, out_t)
    return {k: v.reshape((s, n) + tuple(v.shape[1:])) for k, v in preds.items()}


def _pred_boxes_depths(model, preds, output_inds, out_t):
    """Per-instance box (ULBR; converted from cwh unless the model
    forecasts ulbr) and depth (the column after the box state) at the
    requested output index of the forecast steps (``traj[:, :, -out_t:]``:
    index 0 is the first forecast step); ``output_inds`` (S, N), a tensor
    or numpy. (S, N, 4) and (S, N) f32 tensors."""
    traj = preds["unnormalized_trajectory"][:, :, -out_t:]  # (S, N, out_t, D)
    s, n = traj.shape[:2]
    idx = torch.as_tensor(output_inds, device=traj.device).reshape(s, n)
    sel = torch.take_along_dim(traj, idx.long()[:, :, None, None], dim=2)[:, :, 0]
    boxes = sel[..., :4]
    if not model.use_bbox_ulbr:
        boxes = bbox_cwh_to_ulbr(boxes)
    depths = (sel[..., model.traj_dim] if model.use_depth_inp
              else sel.new_zeros(sel.shape[:2]))
    return boxes.to(torch.float32), depths.to(torch.float32)


def visit_order(depths, classes, valid, *, use_depth_sorting, panoptic=True):
    """The paint order of S scenes' instances and their painted ids, on
    the tensors' device: depths, classes, valid (S, N).

    -> (order (S, N), ids (S, N) int32 in visit order). The order is a
    stable argsort of ``-depth`` with padded slots last under
    ``use_depth_sorting``, else slot order. An id is ``(class+11)·1000 +
    rank`` with ``panoptic`` (rank: the count of earlier valid instances
    of the class in visit order), else ``class+11``; 0 for padded slots."""
    s, n = depths.shape
    pos = torch.arange(n, device=depths.device)
    if use_depth_sorting:
        key = torch.where(valid, -depths, torch.full_like(depths, float("inf")))
        order = torch.argsort(key, dim=1, stable=True)
    else:
        order = pos.expand(s, n)
    cls_s = torch.take_along_dim(classes, order, 1)
    val_s = torch.take_along_dim(valid, order, 1)
    ids = cls_s + N_STUFF
    if panoptic:
        earlier_same = ((cls_s[:, None, :] == cls_s[:, :, None])
                        & (pos[None, :] < pos[:, None]) & val_s[:, None, :])
        ids = ids * 1000 + earlier_same.sum(2)
    return order, torch.where(val_s, ids, 0).to(torch.int32)


def composite(masks, boxes, depths, valid, order, ids, canvas, bg_depth=None, *,
              use_depth_sorting, threshold=0.5):
    """S scenes' instances pasted at their boxes and composited over
    ``canvas`` (S, H, W) int32 in the visit order ``order``, in one call
    on the tensors' device. masks (S, N, Hm, Wm) probabilities, boxes
    (S, N, 4), depths and valid (S, N) in slot order; ids (S, N) in visit
    order (``visit_order``). With ``bg_depth`` (S, H, W) and
    ``use_depth_sorting`` an instance paints only where it is nearer
    (depth <= 0 is unknown: 1e9).

    -> (segs (S, H, W) int32, ids (S, N) in slot order)."""
    rows = torch.arange(order.shape[0], device=order.device)[:, None]
    img_h, img_w = canvas.shape[-2:]
    use_depth = use_depth_sorting and bg_depth is not None
    if bg_depth is None:
        bg_depth = torch.full(canvas.shape, 1e9, dtype=torch.float32, device=canvas.device)
    else:
        bg_depth = torch.where(bg_depth > 0, bg_depth, 1e9)
    segs, _ = paste_and_composite_scenes(
        masks[rows, order], boxes[rows, order], depths[rows, order], ids,
        valid[rows, order], canvas, bg_depth, img_h=img_h, img_w=img_w,
        threshold=threshold, use_depth=use_depth)
    return segs, torch.zeros_like(ids).scatter_(1, order, ids)


def fuse_scenes(model, masks, boxes, depths, classes, valid, bg_labels,
                bg_depths=None, panoptic=True, threshold=0.5):
    """Composite a batch of scenes in one device call.

    masks (S, N, Hm, Wm) probabilities, boxes (S, N, 4) and depths (S, N)
    tensors on the device; classes, valid (S, N) and bg_labels (S, H, W)
    (and bg_depths) numpy. Returns (segs (S, H, W) int32, ids (S, N)):
    ``ids[b, k]`` is the painted id of instance k (0 for padded slots)."""
    dev = masks.device
    valid = torch.as_tensor(np.asarray(valid, bool), device=dev)
    order, ids = visit_order(depths, torch.as_tensor(np.asarray(classes), device=dev), valid,
                             use_depth_sorting=model.use_depth_sorting, panoptic=panoptic)
    if bg_depths is not None:
        bg_depths = torch.as_tensor(np.asarray(bg_depths, np.float32), device=dev)
    segs, ids = composite(masks, boxes, depths, valid, order, ids,
                          torch.as_tensor(np.asarray(bg_labels, np.int32), device=dev),
                          bg_depths, use_depth_sorting=model.use_depth_sorting,
                          threshold=threshold)
    return segs.cpu().numpy(), ids.cpu().numpy().astype(np.int64)


def _bg_depths_from_batch(batch) -> Optional[np.ndarray]:
    """The scenes' optional background depth for the composite's z-buffer
    (fg_model.py:522-527); with a ``background_depth_mask`` the masked
    pixels become unknown (the reference's intent at :565-566)."""
    bg_depths = batch["inputs"].get("background_depth")
    if bg_depths is None:
        return None
    bgd = np.asarray(bg_depths, np.float32)
    m = batch["inputs"].get("background_depth_mask")
    if m is not None:
        bgd = np.where(np.asarray(m, bool), bgd, -1.0)  # -> unknown (1e9)
    return bgd


def _forward_instances(model, batch):
    """-> (boxes, depths, mask probabilities) tensors, classes and valid
    numpy, all (S, N, ...)."""
    preds = run_scene_forward(model, batch)
    out_t = int(np.asarray(batch["labels"]["trajectories"]).shape[2])
    boxes, depths = _pred_boxes_depths(model, preds, batch["labels"]["output_inds"],
                                       out_t)
    masks = torch.sigmoid(preds["masks"])
    valid = np.asarray(batch["inputs"]["valid"], bool)
    classes = np.asarray(batch["inputs"]["classes"])
    return boxes, depths, masks, classes, valid


def _canvas(batch, s, things_void):
    backgrounds = batch["inputs"].get("background")
    if backgrounds is None:
        return np.full((s, IMG_H, IMG_W), 255, np.int64)
    bg = np.asarray(backgrounds).astype(np.int64)
    return np.where(bg >= N_STUFF, 255, bg) if things_void else bg


def predict_panoptic(model, batch) -> Dict[str, Any]:
    """Batched panoptic fusion: seg (S, H, W) panoptic maps in
    trainId·1000+inst space, with each scene's instance ids, boxes,
    depths and mask probabilities."""
    boxes, depths, masks, classes, valid = _forward_instances(model, batch)
    bg = _canvas(batch, masks.shape[0], things_void=True)
    segs, ids = fuse_scenes(model, masks, boxes, depths, classes, valid, bg,
                            bg_depths=_bg_depths_from_batch(batch), panoptic=True)
    return {"seg": segs, "ids": list(ids), "bbox": boxes.cpu().numpy(),
            "depths": depths.cpu().numpy(), "masks": masks.cpu().numpy()}


def predict_semantics(model, batch) -> Dict[str, Any]:
    """Semantic fusion: instance pixels take trainId class+11; the
    background canvas is used as it is."""
    boxes, depths, masks, classes, valid = _forward_instances(model, batch)
    bg = _canvas(batch, masks.shape[0], things_void=False)
    segs, _ = fuse_scenes(model, masks, boxes, depths, classes, valid, bg,
                          bg_depths=_bg_depths_from_batch(batch), panoptic=False)
    return {"seg": segs, "bbox": boxes.cpu().numpy(), "depths": depths.cpu().numpy()}


def predict_instances(model, batch) -> Dict[str, Any]:
    """Per-instance pasted masks for the AP export (fg_model.py:597-746).

    All instances are composited into one scene map in visit order (later
    = nearer instances overwrite, no z-buffer), then each instance's mask
    is read back from it: overlapped pixels belong to the nearer
    instance, and a fully occluded instance is dropped. Output order is
    visit order; the score is the batch's ``inst_scores`` where given,
    else 1.0. The canvas follows the scene background's shape where there
    is one (the reference's is always 1024×2048, fg_model.py:646, 712),
    as in JAX."""
    boxes, depths, masks, classes, valid = _forward_instances(model, batch)
    s, n = masks.shape[:2]
    backgrounds = batch["inputs"].get("background")
    img_h, img_w = (np.asarray(backgrounds).shape[-2:] if backgrounds is not None
                    else (IMG_H, IMG_W))
    dev = masks.device
    valid_t = torch.as_tensor(valid, device=dev)
    order, _ = visit_order(depths, torch.as_tensor(classes, device=dev), valid_t,
                           use_depth_sorting=model.use_depth_sorting)
    # visit ids, in visit order: (position + 1)·1000
    visit_ids = torch.where(torch.take_along_dim(valid_t, order, 1),
                            (torch.arange(n, device=dev) + 1) * 1000, 0).to(torch.int32)
    segs, _ = composite(masks, boxes, depths, valid_t, order, visit_ids,
                        torch.zeros((s, img_h, img_w), dtype=torch.int32, device=dev),
                        use_depth_sorting=model.use_depth_sorting)
    segs, orders = segs.cpu().numpy(), order.cpu().numpy()
    depths_np = depths.cpu().numpy()
    boxes_np = boxes.cpu().numpy()
    inst_scores = batch["inputs"].get("inst_scores")
    scenes: List[List[Dict[str, Any]]] = []
    for b in range(s):
        insts = []
        for pos in range(n):
            k = orders[b, pos]
            if not valid[b, k]:
                continue
            binary = segs[b] == (pos + 1) * 1000
            if not binary.any():
                continue  # fully occluded: dropped (fg_model.py:731-736)
            score = 1.0 if inst_scores is None else float(inst_scores[b][k])
            insts.append({
                "mask": binary,
                "class_train_id": int(classes[b, k]) + N_STUFF,
                "bbox_ulbr": boxes_np[b, k],
                "depth": float(depths_np[b, k]),
                "score": score,
            })
        scenes.append(insts)
    return {"instances": scenes}
