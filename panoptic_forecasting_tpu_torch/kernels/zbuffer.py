"""Packed z-buffer splat: the hot step of the point-cloud transform.

Counterpart of ``panoptic_forecasting_tpu/kernels/zbuffer.py``, packed
path (scalar labels <= 255), which is the path the forecast runs.
Semantics (reference ``pc_transform_model.py:100-139``):

  * each point splats to its 4 surrounding integer pixels (floor/ceil of
    u, v), clamped into bounds, so off-screen points pile on the border;
  * invalid points still take part, with label 0 and a per-batch sentinel
    depth of ``max(valid depth) + 1`` so they never beat a valid point;
  * the winner per pixel is the smallest key = depth bits [31:8] | label,
    so depth keeps only its top 24 bits and ties go to the smallest label;
  * untouched pixels keep label 0 and depth -1.

The JAX algorithm is kept: one key per point, one group per point in a
(batch, corner, pixel) layout of 4 planes per batch, a dense min-canvas
(K1, ``placement.place_min``), then the 4-plane corner fold. Only the
sort is gone: K1 takes the unsorted stream.

Not ported (raise ``NotImplementedError``): the exact ``method='sort'``
path for labels > 255 and vector payloads (RGB images).
"""

from __future__ import annotations

import torch

from .placement import EMPTY, place_min

_INT_MIN = -2147483648


def _depth_sort_bits(depth: torch.Tensor) -> torch.Tensor:
    """Monotone float32 -> int32 key (JAX ``_depth_sort_bits``)."""
    bits = depth.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(bits < 0, ~bits, bits | _INT_MIN) ^ _INT_MIN


def _floor_to_int(x: torch.Tensor, hi: int) -> torch.Tensor:
    """int32 cast of an integral float that agrees with XLA's saturating
    cast after the caller clamps to [0, hi - 1].

    XLA saturates out-of-range f32 -> int32 casts and sends NaN to 0;
    torch leaves them undefined (-2^31 on x86). Clamping to [-1, hi] in
    float first keeps every clamped corner and offset of the JAX code.
    """
    x = torch.nan_to_num(x, nan=0.0, posinf=float(hi), neginf=-1.0)
    return x.clamp(-1.0, float(hi)).to(torch.int32)


def packed_stream(uv: torch.Tensor, depth: torch.Tensor, label: torch.Tensor,
                  height: int, width: int):
    """(group, key) int32 streams of the packed z-buffer, (B, N) each.

    uv (B, N, 2), depth/label (B, N) after sentinel handling. group =
    b·4P + (fv·2 + fu)·P + (cv0·W + cu0) with the clamped floor corner
    (cu0, cv0) and the clamped ceil offsets (fu, fv) of JAX ``_zbuffer_
    packed`` (:130-152); key = depth_bits & ~0xFF | label & 0xFF.
    """
    num_pixels = height * width
    b = uv.shape[0]
    if b * 4 * num_pixels >= 2**31:
        raise ValueError(
            f"batch {b} x canvas {num_pixels} overflows int32 group space"
        )
    dbits = _depth_sort_bits(depth)
    key = (dbits & ~0xFF) | (label.to(torch.int32) & 0xFF)

    u, v = uv[..., 0], uv[..., 1]
    uf, vf = torch.floor(u), torch.floor(v)
    gu = (torch.ceil(u) != uf).to(torch.int32)  # ceil - floor in {0, 1}
    gv = (torch.ceil(v) != vf).to(torch.int32)
    ui = _floor_to_int(uf, width)
    vi = _floor_to_int(vf, height)
    cu0 = ui.clamp(0, width - 1)
    cv0 = vi.clamp(0, height - 1)
    fu = (ui + gu).clamp(0, width - 1) - cu0
    fv = (vi + gv).clamp(0, height - 1) - cv0
    group = (fv * 2 + fu) * num_pixels + (cv0 * width + cu0)
    offs = torch.arange(b, dtype=torch.int32, device=uv.device) * (4 * num_pixels)
    return group + offs[:, None], key


def _shift2(c: torch.Tensor, dv: int, du: int) -> torch.Tensor:
    """Shift (b, H, W) down by dv rows and right by du columns, EMPTY in."""
    out = torch.full_like(c, EMPTY)
    h, w = c.shape[-2:]
    out[:, dv:, du:] = c[:, : h - dv, : w - du]
    return out


def _fold_corners(canvas4: torch.Tensor, b: int, height: int, width: int):
    """(b·4·P,) corner canvases -> (b, H, W) min canvas (JAX :238-254)."""
    g = canvas4.view(b, 4, height, width)
    g0, g1, g2, g3 = g.unbind(1)
    m00 = torch.minimum(torch.minimum(g0, g1), torch.minimum(g2, g3))
    m10 = torch.minimum(g1, g3)  # points whose ceil-u corner is base+1
    m01 = torch.minimum(g2, g3)
    return torch.minimum(
        torch.minimum(m00, _shift2(m10, 0, 1)),
        torch.minimum(_shift2(m01, 1, 0), _shift2(g3, 1, 1)),
    )


def splat_stream(uv: torch.Tensor, depth: torch.Tensor, label: torch.Tensor,
                 valid: torch.Tensor, *, height: int, width: int,
                 max_label: int = 255):
    """The (group, key) stream K1 places, and its canvas size.

    uv (B, N, 2), depth/label/valid (B, N). Invalid points get label 0 and
    the per-batch sentinel depth ``max(valid depth) + 1`` (pc_transform_
    model.py:104-106 semantics). Returns (group (B·N,), key (B·N,),
    num_groups = B·4·H·W).
    """
    if label.shape != depth.shape:
        raise ValueError(
            f"label {tuple(label.shape)} must match depth {tuple(depth.shape)}"
        )
    if max_label > 255:
        raise NotImplementedError(
            f"max_label={max_label} needs the exact sort z-buffer (the "
            "packed key holds 8 label bits), not yet ported"
        )
    neg_inf = torch.tensor(-float("inf"), dtype=depth.dtype, device=depth.device)
    sentinel = torch.where(valid, depth, neg_inf).amax(-1, keepdim=True)
    sentinel = torch.where(torch.isfinite(sentinel), sentinel, 0.0) + 1.0
    depth = torch.where(valid, depth, sentinel).to(torch.float32)
    label = torch.where(valid, label, torch.zeros((), dtype=label.dtype,
                                                   device=label.device))
    group, key = packed_stream(uv, depth, label, height, width)
    return group.reshape(-1), key.reshape(-1), uv.shape[0] * 4 * height * width


def zbuffer_splat(uv: torch.Tensor, depth: torch.Tensor, label: torch.Tensor,
                  valid: torch.Tensor, *, height: int, width: int,
                  max_label: int = 255):
    """Forward-splat a point stream into a (H, W) label + depth canvas.

    uv (..., N, 2) float pixel coords; depth (..., N) float; label
    (..., N) int with values in [0, max_label]; valid (..., N) bool.
    Returns (label_canvas (..., H, W), depth_canvas (..., H, W)), equal
    bit for bit to JAX ``zbuffer_splat(method='packed')``.
    """
    if label.dim() != uv.dim() - 1:
        raise NotImplementedError(
            "vector payloads need the exact sort z-buffer, not yet ported"
        )
    lead = uv.shape[:-2]
    n = uv.shape[-2]
    group, key, num_groups = splat_stream(
        uv.reshape(-1, n, 2), depth.reshape(-1, n), label.reshape(-1, n),
        valid.reshape(-1, n), height=height, width=width, max_label=max_label,
    )
    canvas = _fold_corners(place_min(group, key, num_groups),
                           num_groups // (4 * height * width), height, width)
    touched = canvas != EMPTY
    out_label = torch.where(touched, canvas & 0xFF, 0).to(label.dtype)
    # All stored depths are positive, so the depth bits are the float bits.
    out_depth = (canvas & ~0xFF).view(torch.float32)
    out_depth = torch.where(touched, out_depth, -1.0)
    return (out_label.reshape(lead + (height, width)),
            out_depth.reshape(lead + (height, width)))
