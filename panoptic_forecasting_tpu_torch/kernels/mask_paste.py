"""Mask pasting and depth-ordered compositing.

Counterpart of ``panoptic_forecasting_tpu/kernels/mask_paste.py``
(reference ``model_utils.paste_mask``, a ``F.grid_sample(align_corners=
False)`` over the image grid per instance). Bilinear resampling on an
axis-aligned grid is separable: ``out = Wy @ mask @ Wxᵀ`` with hat-
function weights, batched over instances as two ``bmm``s (a plain
product, left to PyTorch as the JAX code leaves it to XLA). The
composite runs over a batch of scenes at once.
"""

from __future__ import annotations

import torch


def _hat(img_n: int, lo: torch.Tensor, extent: torch.Tensor, m: int):
    """(N, img_n, m) hat weights of source cells for target pixels."""
    g = torch.arange(img_n, dtype=torch.float32, device=lo.device)
    g = ((g + 0.5)[None, :] - lo[:, None]) / extent[:, None] * 2 - 1
    s = ((g + 1) * m - 1) / 2  # align_corners=False: normalized -> source
    a = torch.arange(m, dtype=torch.float32, device=lo.device)
    return torch.clamp(1.0 - (s[..., None] - a).abs(), min=0.0)


def paste_masks_bilinear(masks: torch.Tensor, bboxes_ulbr: torch.Tensor, *,
                         img_h: int, img_w: int) -> torch.Tensor:
    """Paste (N, Hm, Wm) masks at (N, 4) boxes -> (N, img_h, img_w).

    Matches ``F.grid_sample(..., align_corners=False)`` over the
    normalized-box grid; degenerate boxes (zero extent) paste zeros.
    """
    n, mh, mw = masks.shape
    x0, y0, x1, y1 = bboxes_ulbr.to(torch.float32).unbind(-1)
    bw, bh = x1 - x0, y1 - y0
    deg_w, deg_h = bw.abs() < 1e-6, bh.abs() < 1e-6
    safe_bw = torch.where(deg_w, torch.ones_like(bw), bw)
    safe_bh = torch.where(deg_h, torch.ones_like(bh), bh)
    wy = _hat(img_h, y0, safe_bh, mh)  # (N, img_h, mh)
    wx = _hat(img_w, x0, safe_bw, mw)  # (N, img_w, mw)
    out = torch.bmm(torch.bmm(wy, masks.to(torch.float32)), wx.transpose(1, 2))
    return torch.where((deg_w | deg_h)[:, None, None], 0.0, out)


def paste_and_composite_scenes(masks, bboxes_ulbr, depths, ids, valid,
                               bg_labels, bg_depth, *, img_h: int, img_w: int,
                               threshold: float = 0.5, use_depth: bool = True):
    """Composite S scenes of N instances, already in paint order, over
    their backgrounds (the JAX package vmaps its one-scene
    ``paste_and_composite`` over scenes, ``eval/fusion.py``).

    A pixel takes an instance's id when its pasted probability is
    ``>= threshold`` and, with ``use_depth``, the instance is strictly
    nearer than the current z-buffer (``depth < current``); later
    instances otherwise overwrite (fg_model.py:557-588).

    masks (S, N, Hm, Wm) probabilities; bboxes_ulbr (S, N, 4);
    depths/valid (S, N); ids (S, N) int32; bg_labels (S, H, W) int32;
    bg_depth (S, H, W) f32. Returns (S, H, W) label and depth canvases."""
    s, n, mh, mw = masks.shape
    pasted = paste_masks_bilinear(
        masks.reshape(s * n, mh, mw), bboxes_ulbr.reshape(s * n, 4),
        img_h=img_h, img_w=img_w).reshape(s, n, img_h, img_w)
    label_c, depth_c = bg_labels, bg_depth
    for k in range(n):
        write = (pasted[:, k] >= threshold) & valid[:, k, None, None]
        if use_depth:
            d = depths[:, k, None, None]
            write = write & (d < depth_c)
            depth_c = torch.where(write, d, depth_c)
        label_c = torch.where(write, ids[:, k, None, None], label_c)
    return label_c, depth_c
