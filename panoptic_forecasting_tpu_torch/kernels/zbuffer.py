"""Z-buffer splat: the hot step of the point-cloud transform.

Counterpart of ``panoptic_forecasting_tpu/kernels/zbuffer.py``.
Semantics (reference ``pc_transform_model.py:100-139``):

  * each point splats to its 4 surrounding integer pixels (floor/ceil of
    u, v), clamped into bounds, so off-screen points pile on the border;
  * invalid points still take part, with label 0 and a per-sample
    sentinel depth of ``max(valid depth) + 1`` so they never beat a valid
    point;
  * untouched pixels keep label 0 and depth -1.

Two families of paths, routed by ``zbuffer_splat(method=...)`` as in JAX:

* **packed** (scalar labels <= 255; the path the forecast runs): the
  winner per pixel is the smallest key = depth bits [31:8] | label, so
  depth keeps only its top 24 bits and ties go to the smallest label. The
  JAX stream is kept: one key per point, one group per point in a
  (batch, corner, pixel) layout of 4 planes per batch. JAX places it
  sorted into a 4-plane min-canvas and folds the corners; here K1's
  ``placement.place_min_fold`` places the unsorted stream straight into
  the one-plane canvas, each point at its <= 4 pixels, with the same
  result bit for bit.
* **exact** (``sort``, and ``scatter`` for cross-checking; any label,
  vector payloads such as RGB): the 4N-entry expanded stream, full f32
  depth, ties to the smallest index of the stream. Plain PyTorch, as in
  JAX, where these are ``lax.sort`` and XLA scatters with no Pallas.
"""

from __future__ import annotations

import torch

from .placement import EMPTY, place_min_fold

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


def _fill_invalid(depth: torch.Tensor, label: torch.Tensor,
                  valid: torch.Tensor):
    """Invalid points get label 0 (every channel of a vector payload) and
    the per-sample sentinel depth ``max(valid depth) + 1``
    (pc_transform_model.py:104-106 semantics; JAX :350-361). depth/valid
    (B, N), label (B, N[, C]); the depth comes back float32."""
    neg_inf = torch.tensor(-float("inf"), dtype=depth.dtype, device=depth.device)
    sentinel = torch.where(valid, depth, neg_inf).amax(-1, keepdim=True)
    sentinel = torch.where(torch.isfinite(sentinel), sentinel, 0.0) + 1.0
    depth = torch.where(valid, depth, sentinel).to(torch.float32)
    keep = valid if label.dim() == valid.dim() else valid[..., None]
    label = torch.where(keep, label, torch.zeros((), dtype=label.dtype,
                                                 device=label.device))
    return depth, label


def splat_stream(uv: torch.Tensor, depth: torch.Tensor, label: torch.Tensor,
                 valid: torch.Tensor, *, height: int, width: int,
                 max_label: int = 255):
    """The (group, key) stream K1 places, and the size of its 4-plane
    group space.

    uv (B, N, 2), depth/label/valid (B, N), labels in [0, max_label] with
    max_label <= 255 (the packed key holds 8 label bits). Returns
    (group (B·N,), key (B·N,), num_groups = B·4·H·W).
    """
    if label.shape != depth.shape:
        raise ValueError(
            f"label {tuple(label.shape)} must match depth {tuple(depth.shape)}"
        )
    if max_label > 255:
        raise ValueError(
            f"packed z-buffer packs the label into 8 bits; max_label="
            f"{max_label} would alias. Use method='sort' (or 'auto')."
        )
    depth, label = _fill_invalid(depth, label, valid)
    group, key = packed_stream(uv, depth, label, height, width)
    return group.reshape(-1), key.reshape(-1), uv.shape[0] * 4 * height * width


def _zbuffer_packed(uv, depth, label, valid, height, width, max_label):
    """The packed path on (B, N) streams -> (B, H, W) label and depth."""
    group, key, _ = splat_stream(
        uv, depth, label, valid, height=height, width=width,
        max_label=max_label,
    )
    canvas = place_min_fold(group, key, batch=uv.shape[0], height=height,
                            width=width)
    return decode_canvas(canvas, label.dtype)


def decode_canvas(canvas: torch.Tensor, label_dtype: torch.dtype):
    """Packed min canvas -> (label, depth): label bits [7:0] and depth bits
    [31:8] of each winning key; untouched pixels get label 0, depth -1."""
    touched = canvas != EMPTY
    out_label = torch.where(touched, canvas & 0xFF, 0).to(label_dtype)
    # All stored depths are positive, so the depth bits are the float bits.
    out_depth = (canvas & ~0xFF).view(torch.float32)
    return out_label, torch.where(touched, out_depth, -1.0)


def splat_four_neighbors(uv: torch.Tensor, height: int, width: int):
    """(..., N, 2) float pixel coords -> (..., 4N) flat pixel indices
    v·width + u of the 4 surrounding integer pixels, clamped in bounds,
    in the JAX order: u [floor, floor, ceil, ceil] x v [floor, ceil,
    floor, ceil], each a run of N (JAX :45-58)."""
    u, v = uv[..., 0], uv[..., 1]
    uf, uc = torch.floor(u), torch.ceil(u)
    vf, vc = torch.floor(v), torch.ceil(v)
    us = torch.cat([uf, uf, uc, uc], -1)
    vs = torch.cat([vf, vc, vf, vc], -1)
    ui = _floor_to_int(us, width).clamp(0, width - 1)
    vi = _floor_to_int(vs, height).clamp(0, height - 1)
    return vi * width + ui


def _canvas_index(pix: torch.Tensor, num_pixels: int) -> torch.Tensor:
    """(B, M) pixel indices -> int64 indices into a (B·P,) canvas."""
    b = pix.shape[0]
    offs = torch.arange(b, dtype=torch.int64, device=pix.device) * num_pixels
    return pix.to(torch.int64) + offs[:, None]


def _zbuffer_sort(pix, depth, label, num_pixels: int):
    """Sort-based argmin per pixel (JAX :61-78), batched: pix/depth/label
    (B, M) -> (B, P) canvases.

    JAX's ``lax.sort`` over (pixel, depth bits) is stable, so depth ties
    go to the smallest stream index; one stable sort of the int64 key
    (batch·P + pixel) · 2^32 + (depth bits + 2^31) orders the same way,
    and batch-major keeps the samples apart as JAX's vmap does. The first
    entry of each pixel's run wins.
    """
    b = pix.shape[0]
    row = _canvas_index(pix, num_pixels)
    dkey = _depth_sort_bits(depth).to(torch.int64) + 2**31
    _, order = torch.sort((row * 2**32 + dkey).reshape(-1), stable=True)
    tgt = row.reshape(-1)[order]
    first = torch.ones_like(tgt, dtype=torch.bool)
    first[1:] = tgt[1:] != tgt[:-1]
    win = order[first]
    tgt = tgt[first]
    canvas_label = torch.zeros(b * num_pixels, dtype=label.dtype,
                               device=label.device)
    canvas_depth = torch.full((b * num_pixels,), -1.0, dtype=depth.dtype,
                              device=depth.device)
    canvas_label[tgt] = label.reshape(-1)[win]
    canvas_depth[tgt] = depth.reshape(-1)[win]
    return canvas_label.view(b, num_pixels), canvas_depth.view(b, num_pixels)


def _zbuffer_scatter(pix, depth, label, num_pixels: int):
    """Direct scatter-min path (JAX :268-285), batched like
    ``_zbuffer_sort``: the min depth per pixel, then the smallest stream
    index among the points that reach it."""
    b, m = pix.shape
    tgt = _canvas_index(pix, num_pixels)
    min_depth = torch.full((b * num_pixels,), float("inf"), dtype=depth.dtype,
                           device=depth.device)
    min_depth.scatter_reduce_(0, tgt.reshape(-1), depth.reshape(-1), "amin")
    won = depth == min_depth[tgt]
    idx = torch.arange(m, dtype=torch.int64, device=pix.device).expand(b, m)
    win_idx = torch.full((b * num_pixels,), m, dtype=torch.int64,
                         device=pix.device)
    win_idx.scatter_reduce_(0, tgt[won], idx[won], "amin")
    win_idx = win_idx.view(b, num_pixels)
    touched = win_idx < m
    safe = torch.where(touched, win_idx, 0)
    canvas_label = torch.where(touched, label.gather(1, safe),
                               torch.zeros((), dtype=label.dtype,
                                           device=label.device))
    canvas_depth = torch.where(touched, depth.gather(1, safe), -1.0)
    return canvas_label, canvas_depth


def _zbuffer_exact(uv, depth, label, valid, height, width, method):
    """The expanded-stream paths (JAX :383-406) on (B, N) streams ->
    label (B, H, W[, C]) and depth (B, H, W)."""
    b, n = depth.shape
    depth, label = _fill_invalid(depth, label, valid)
    pix = splat_four_neighbors(uv, height, width)  # (B, 4N)
    depth4 = depth.repeat(1, 4)
    num_pixels = height * width
    impl = _zbuffer_sort if method == "sort" else _zbuffer_scatter
    if label.dim() == 3:
        # Vector payload (RGB images): z-buffer the point index + 1 (0 =
        # untouched), then gather the winners' rows.
        idx4 = torch.arange(1, n + 1, dtype=torch.int32,
                            device=pix.device).repeat(4).expand(b, 4 * n)
        win, dcanvas = impl(pix, depth4, idx4, num_pixels)
        touched = win > 0
        safe = torch.where(touched, win - 1, 0).to(torch.int64)
        rows = label.gather(1, safe[..., None].expand(-1, -1, label.shape[-1]))
        lcanvas = torch.where(touched[..., None], rows,
                              torch.zeros((), dtype=label.dtype,
                                          device=label.device))
        return (lcanvas.view(b, height, width, label.shape[-1]),
                dcanvas.view(b, height, width))
    lcanvas, dcanvas = impl(pix, depth4, label.repeat(1, 4), num_pixels)
    return lcanvas.view(b, height, width), dcanvas.view(b, height, width)


PACKED_METHODS = ("packed", "pallas", "pallas_interpret")
EXACT_METHODS = ("sort", "scatter")


def zbuffer_splat(uv: torch.Tensor, depth: torch.Tensor, label: torch.Tensor,
                  valid: torch.Tensor, *, height: int, width: int,
                  method: str = "auto", max_label: int = 255):
    """Forward-splat a point stream into a (H, W) label + depth canvas.

    uv (..., N, 2) float pixel coords; depth (..., N) float; label
    (..., N) int with values in [0, max_label], or (..., N, C) a vector
    payload; valid (..., N) bool. Returns (label_canvas (..., H, W[, C]),
    depth_canvas (..., H, W)), equal bit for bit to JAX ``zbuffer_splat``
    with the same ``method``:

    * ``auto``: packed when the label is scalar and ``max_label <= 255``,
      else ``sort``;
    * ``packed`` (and the TPU names ``pallas``, ``pallas_interpret``): the
      packed path through K1; raises ``ValueError`` for ``max_label >
      255`` (the label would alias) and for vector payloads;
    * ``sort`` / ``scatter``: the exact paths.
    """
    scalar_label = label.dim() == uv.dim() - 1
    if method == "auto":
        method = "packed" if scalar_label and max_label <= 255 else "sort"
    if method in PACKED_METHODS and not scalar_label:
        raise ValueError("packed z-buffer supports scalar labels only")
    if method not in PACKED_METHODS + EXACT_METHODS:
        raise ValueError(
            f"unknown method {method!r}; expected 'auto' or one of "
            f"{PACKED_METHODS + EXACT_METHODS}"
        )
    lead = uv.shape[:-2]
    n = uv.shape[-2]
    args = (uv.reshape(-1, n, 2), depth.reshape(-1, n),
            label.reshape((-1, n) + label.shape[len(lead) + 1:]),
            valid.reshape(-1, n), height, width)
    if method in PACKED_METHODS:
        lab, dep = _zbuffer_packed(*args, max_label)
    else:
        lab, dep = _zbuffer_exact(*args, method)
    return (lab.reshape(lead + lab.shape[1:]),
            dep.reshape(lead + (height, width)))
