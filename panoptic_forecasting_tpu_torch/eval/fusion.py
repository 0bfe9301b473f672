"""Panoptic / semantic / instance fusion of fg forecasts over bg canvases.

Counterpart of ``panoptic_forecasting_tpu/eval/fusion.py`` (reference
``FGModel.predict_semantics`` / ``predict_panoptic`` /
``predict_instances``, fg_model.py:389-746): forward the scenes'
instances, sigmoid the mask logits, paste each 28×28 mask at its
predicted box, threshold at 0.5 and composite far to near (descending
predicted depth) over the background canvas.

The visit order (a stable ``argsort`` of ``-depth``) and the ids stay on
the host in numpy, as in JAX: panoptic ids are ``(class+11)·1000 + k``
with per-class counters in visit order. Thing pixels (>= 11) of the
canvas become 255 before the composite. With a background depth map the
composite z-buffers against it (strict ``<``, unknown depth 1e9, and a
``background_depth_mask`` turns masked pixels unknown); otherwise later
(nearer) instances overwrite. Everything pixel-sized runs on the fg
model's device, the scenes of a batch in one composite
(``kernels/mask_paste.py::paste_and_composite_scenes``).

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
    index 0 is the first forecast step). (S, N, 4) and (S, N) f32
    tensors."""
    traj = preds["unnormalized_trajectory"][:, :, -out_t:]  # (S, N, out_t, D)
    s, n = traj.shape[:2]
    idx = torch.as_tensor(np.asarray(output_inds).reshape(s, n), device=traj.device)
    sel = torch.take_along_dim(traj, idx.long()[:, :, None, None], dim=2)[:, :, 0]
    boxes = sel[..., :4]
    if not model.use_bbox_ulbr:
        boxes = bbox_cwh_to_ulbr(boxes)
    depths = (sel[..., model.traj_dim] if model.use_depth_inp
              else sel.new_zeros(sel.shape[:2]))
    return boxes.to(torch.float32), depths.to(torch.float32)


def _order_and_ids(model, depths, classes, valid, panoptic):
    """Host-side visit order + painted ids for one scene (tiny arrays)."""
    n = depths.shape[0]
    if model.use_depth_sorting:
        order = np.argsort(np.where(valid, -depths, np.inf), kind="stable")
    else:
        order = np.arange(n)
    ids = np.zeros(n, np.int64)
    counters: Dict[int, int] = {}
    for k in order:
        if not valid[k]:
            continue
        cl = int(classes[k]) + 11
        if panoptic:
            c = counters.get(cl, 0)
            counters[cl] = c + 1
            ids[k] = cl * 1000 + c
        else:
            ids[k] = cl
    return order, ids


def _composite(masks, boxes, depths, ids, valid, bg_labels, bg_depths,
               orders, threshold, use_depth):
    """The scenes' instances in visit order (``orders`` (S, N)) pasted
    and composited on the masks' device -> (S, H, W) int32 numpy."""
    dev = masks.device
    s = masks.shape[0]
    take = torch.arange(s, device=dev)[:, None]
    o = torch.as_tensor(orders, device=dev)
    img_h, img_w = bg_labels.shape[-2:]
    segs, _ = paste_and_composite_scenes(
        masks[take, o], boxes[take, o], depths[take, o],
        torch.as_tensor(np.take_along_axis(ids, orders, 1).astype(np.int32), device=dev),
        torch.as_tensor(np.take_along_axis(valid, orders, 1), device=dev),
        torch.as_tensor(np.asarray(bg_labels, np.int32), device=dev),
        torch.as_tensor(np.asarray(bg_depths, np.float32), device=dev),
        img_h=img_h, img_w=img_w, threshold=threshold, use_depth=use_depth)
    return segs.cpu().numpy()


def fuse_scenes(model, masks, boxes, depths, classes, valid, bg_labels,
                bg_depths=None, panoptic=True, threshold=0.5):
    """Composite a batch of scenes in one device call.

    masks (S, N, Hm, Wm) probabilities, boxes (S, N, 4) and depths (S, N)
    tensors on the device; classes, valid (S, N) and bg_labels (S, H, W)
    (and bg_depths) numpy. Returns (segs (S, H, W) int32, ids (S, N)):
    ``ids[b, k]`` is the painted id of instance k (0 for padded slots)."""
    s, n = masks.shape[:2]
    depths_np = depths.cpu().numpy()
    orders = np.zeros((s, n), np.int64)
    ids = np.zeros((s, n), np.int64)
    for b in range(s):
        orders[b], ids[b] = _order_and_ids(model, depths_np[b], classes[b],
                                           valid[b], panoptic)
    img_h, img_w = bg_labels.shape[-2:]
    use_depth = bool(model.use_depth_sorting and bg_depths is not None)
    if bg_depths is None:
        bgd = np.full((s, img_h, img_w), 1e9, np.float32)
    else:
        bgd = np.asarray(bg_depths, np.float32)
        bgd = np.where(bgd > 0, bgd, 1e9)
    segs = _composite(masks, boxes, depths, ids, valid, bg_labels, bgd, orders,
                      threshold, use_depth)
    return segs, ids


def fuse_scene(model, masks, boxes, depths, classes, valid, bg_labels,
               bg_depth=None, panoptic=True, threshold=0.5):
    """Composite one scene (the batched path with S = 1)."""
    segs, ids = fuse_scenes(
        model, masks[None], boxes[None], depths[None], classes[None],
        valid[None], np.asarray(bg_labels)[None],
        None if bg_depth is None else np.asarray(bg_depth)[None],
        panoptic=panoptic, threshold=threshold,
    )
    return segs[0], ids[0]


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
    return np.where(bg >= 11, 255, bg) if things_void else bg


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
    depths_np = depths.cpu().numpy()
    orders = np.zeros((s, n), np.int64)
    visit_ids = np.zeros((s, n), np.int64)  # ids in visit-position space
    for b in range(s):
        if model.use_depth_sorting:
            orders[b] = np.argsort(np.where(valid[b], -depths_np[b], np.inf),
                                   kind="stable")
        else:
            orders[b] = np.arange(n)
        visit_ids[b] = np.where(valid[b][orders[b]], (np.arange(n) + 1) * 1000, 0)
    # _composite gathers ids by the order; visit ids are already in it
    slot_ids = np.zeros_like(visit_ids)
    np.put_along_axis(slot_ids, orders, visit_ids, 1)
    segs = _composite(masks, boxes, depths, slot_ids, valid,
                      np.zeros((s, img_h, img_w), np.int32),
                      np.full((s, img_h, img_w), 1e9, np.float32), orders, 0.5,
                      use_depth=False)
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
                "class_train_id": int(classes[b, k]) + 11,
                "bbox_ulbr": boxes_np[b, k],
                "depth": float(depths_np[b, k]),
                "score": score,
            })
        scenes.append(insts)
    return {"instances": scenes}
