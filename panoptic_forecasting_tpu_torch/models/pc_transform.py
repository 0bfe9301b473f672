"""Point-cloud transform: reproject past segmentations into the target
camera with depth and cumulative ego-motion, then z-buffer splat.

Counterpart of ``panoptic_forecasting_tpu/models/pc_transform.py``
(reference ``PCTransformModel.predict``, pc_transform_model.py:26-150).
The 4-matrix chain collapses per (batch, frame) into one affine map
A = E⁻¹·target_T·E, combined with K⁻¹ so the per-pixel work is a
multiply-add over the pixel grid; the splat is the z-buffer of
``kernels/zbuffer.py`` (by default the packed path, K1 on the GPU).
Everything is float32. ``PCTransformModel`` is the task class around
``pc_transform_predict``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.zbuffer import zbuffer_splat


def _f32(x):
    """Round to f32, held in float64 (products of two f32 are exact
    there, so ``_f32(a - b * c)`` is a fused multiply-add)."""
    return np.asarray(x).astype(np.float32).astype(np.float64)


def _lu_factor(a: np.ndarray):
    """LU with partial pivoting of one (n, n) matrix, with the rounding of
    the LAPACK getrf the JAX package's inverse calls on the CPU (a
    left-looking column sweep: each column's U part by reversed dot
    products, its L part by forward dot products, both accumulated with
    fused multiply-adds, then scaled by the f32 reciprocal of the pivot).
    Returns (lu, pivots)."""
    a = _f32(a).copy()
    n = a.shape[0]
    piv = []

    def dot(x, y):
        acc = _f32(x[0] * y[0])
        for xi, yi in zip(x[1:], y[1:]):
            acc = _f32(acc + xi * yi)
        return acc

    for j in range(n):
        b = a[:, j].copy()
        for i, p in enumerate(piv):
            b[i], b[p] = b[p], b[i]
        for i in range(1, j):
            b[i] = _f32(b[i] - dot(a[i, :i][::-1], b[:i][::-1]))
        if j:
            for i in range(j, n):
                b[i] = _f32(b[i] - dot(a[i, :j], b[:j]))
        p = j + int(np.argmax(np.abs(b[j:])))
        piv.append(p)
        if b[p] != 0:
            if p != j:
                a[[j, p], :j] = a[[p, j], :j]
                b[j], b[p] = b[p], b[j]
            b[j + 1:] = _f32(b[j + 1:] * _f32(1.0 / b[j]))
        a[:, j] = b
    return a, piv


def _inv(a: np.ndarray) -> np.ndarray:
    """(..., n, n) inverses with the rounding of the JAX package's
    ``jnp.linalg.inv`` on the CPU: ``_lu_factor``, then the two triangular
    solves of getrs column-wise as LAPACK's trsm does them (each update a
    fused multiply-add, each division a multiply by the f32 reciprocal of
    the pivot). f32 values held in float64."""
    flat = np.asarray(a, np.float64).reshape((-1,) + a.shape[-2:])
    n = a.shape[-1]
    out = np.empty_like(flat)
    for m, mat in enumerate(flat):
        lu, piv = _lu_factor(mat)
        perm = list(range(n))
        for i, p in enumerate(piv):
            perm[i], perm[p] = perm[p], perm[i]
        x = np.eye(n)[perm]  # P^T I
        for k in range(n):  # L y = P^T I, L unit lower
            for i in range(k + 1, n):
                x[i] = _f32(x[i] - x[k] * lu[i, k])
        for k in range(n - 1, -1, -1):  # U x = y
            x[k] = _f32(x[k] * _f32(1.0 / lu[k, k]))
            for i in range(k):
                x[i] = _f32(x[i] - x[k] * lu[i, k])
        out[m] = x
    return out.reshape(a.shape)


def _matmul(a: np.ndarray, b: np.ndarray, fused: bool) -> np.ndarray:
    """f32 matrix product with the rounding of the JAX package's jitted
    einsums on the CPU (HIGHEST-precision dots): the products summed in
    order with fused multiply-adds (``fused``: R·K⁻¹'s three, and the
    (4, 4) chain's four when there is one input frame), or pairwise,
    each rounded, ((p0 + p1) + (p2 + p3)) (the chain over several)."""
    terms = [a[..., :, k, None] * b[..., k, None, :] for k in range(a.shape[-1])]
    if fused:
        acc = _f32(terms[0])
        for t in terms[1:]:
            acc = _f32(acc + t)
        return acc
    terms = [_f32(t) for t in terms]
    while len(terms) > 1:
        terms = [_f32(terms[i] + terms[i + 1]) if i + 1 < len(terms) else terms[i]
                 for i in range(0, len(terms), 2)]
    return terms[0]


def _camera_maps(K, extrinsics, target_T):
    """Per (batch, frame): B = R·K⁻¹ (B, T, 3, 3) and trans (B, T, 3) of
    A = E⁻¹·target_T·E, computed on the host in f32 with the rounding of
    the JAX package's jitted chain on the CPU (``_inv``, ``_matmul``; the
    contraction order (E⁻¹·target_T)·E of its ``einsum``, whose sums XLA
    fuses when there is one input frame).

    The chain is tiny, and computing it in one place makes the GPU and
    the CPU reproject bit-identically: the last bit of a projected point
    decides whether it splats to one column or two, and which truncated
    depth its z-buffer key holds.
    """
    K, E, T = (_f32(torch.as_tensor(x).detach().to("cpu", torch.float32).numpy())
               for x in (K, extrinsics, target_T))
    one = T.shape[1] == 1
    A = _matmul(_matmul(_inv(E)[:, None], T, fused=one), E[:, None], fused=one)
    Bm = _matmul(A[..., :3, :3], _inv(K)[:, None], fused=True)
    return (torch.from_numpy(Bm.astype(np.float32)),
            torch.from_numpy(A[..., :3, 3].astype(np.float32)))


def _fma(a, b, c):
    """a·b + c rounded once to f32 (a fused multiply-add).

    XLA contracts the multiply-adds of this projection into FMAs on the
    CPU; the port rounds the same way. The product and sum are taken in
    float64 (the product of two f32 is exact there), so every device
    gives the same bits.
    """
    return (a.double() * b.double() + c.double()).float()


def _reproject_points(depth, K, extrinsics, target_T, height: int,
                      width: int):
    """Project every pixel of (B, T, H, W) depth into the target camera.

    K (B, 3, 3), extrinsics (B, 4, 4), target_T (B, T, 4, 4).
    Returns (uv (B, T, H, W, 2), z (B, T, H, W)).
    """
    dev = depth.device
    Bm, trans = _camera_maps(K, extrinsics, target_T)
    Bm, trans = Bm.to(dev), trans.to(dev)
    K = K.to(dev, torch.float32)
    u = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    bc = (slice(None), slice(None), None, None)

    one = depth.shape[1] == 1

    def row(i):
        # x_target = depth * (B @ [u, v, 1]) + trans, one FMA per step; for
        # one input frame XLA rounds the x and y rows' B @ [u, v, 1] at
        # every product and sum
        b0, b1, b2 = (Bm[..., i, j][bc] for j in range(3))
        if one and i < 2:
            bp = (b0 * u + b1 * v) + b2
        else:
            bp = _fma(b1, v, b0 * u) + b2
        return _fma(depth, bp, trans[..., i][bc])

    x, y, z = row(0), row(1), row(2)
    tiny = torch.where(z < 0, -1e-8, 1e-8)
    safe_z = torch.where(z.abs() < 1e-8, tiny, z)
    kb = (slice(None), None, None, None)
    uv = torch.stack(
        [_fma(x / safe_z, K[:, 0, 0][kb], K[:, 0, 2][kb]),
         _fma(y / safe_z, K[:, 1, 1][kb], K[:, 1, 2][kb])],
        -1,
    )
    return uv, z


def reproject(seg, depth, depth_mask, K, extrinsics, target_T, *,
              height: int, width: int):
    """Every input pixel as a point of the target camera, flattened per
    batch: (uv (B, N, 2), z (B, N), label (B, N[, C]), valid (B, N)),
    N = T·H·W. A point is valid with valid input depth, z > 0 and on
    screen."""
    uv, z = _reproject_points(depth.to(torch.float32), K, extrinsics,
                              target_T, height, width)
    valid = (
        depth_mask.bool()
        & (z > 0)
        & (uv[..., 0] >= 0)
        & (uv[..., 0] < width)
        & (uv[..., 1] >= 0)
        & (uv[..., 1] < height)
    )
    b = depth.shape[0]
    n = depth.shape[1] * height * width
    return (uv.reshape(b, n, 2), z.reshape(b, n),
            seg.reshape((b, n) + tuple(seg.shape[4:])), valid.reshape(b, n))


def pc_transform_predict(seg, depth, depth_mask, K, extrinsics, target_T, *,
                         height: int, width: int, method: str = "auto",
                         device: DeviceLike = None):
    """Batched reprojection + splat on ``device`` (the GPU unless
    ``device="cpu"``).

    seg (B, T, H, W) int labels, or (B, T, H, W, C) a vector payload (RGB
    images); depth/depth_mask (B, T, H, W), moved to ``device``; K (B, 3,
    3), extrinsics (B, 4, 4) and target_T (B, T, 4, 4) anywhere (the
    camera chain is computed on the host). ``method`` is the z-buffer's
    (``kernels/zbuffer.py::zbuffer_splat``; ``auto`` takes the packed
    path for scalar labels, which must then lie in [0, 255], and ``sort``
    for vector payloads). Returns {"seg": (B, H, W[, C]), "depth": (B, H,
    W)}: the T input frames' points z-buffered into one canvas per batch.
    """
    dev = resolve_device(device)
    seg, depth, depth_mask = (torch.as_tensor(x, device=dev)
                              for x in (seg, depth, depth_mask))
    uv, z, label, valid = reproject(seg, depth, depth_mask, K, extrinsics,
                                    target_T, height=height, width=width)
    lab, dep = zbuffer_splat(uv, z, label, valid, height=height, width=width,
                             method=method)
    return {"seg": lab, "depth": dep}


class PCTransformModel:
    """Stateless geometry engine (no learned parameters; predict-only).

    Counterpart of JAX ``models/pc_transform.py::PCTransformModel``
    (:111-150). Config keys under ``model``: ``only_this_ind`` (reproject
    only that input frame), ``zbuffer_method`` (default ``auto``) and
    ``is_img``, kept as in JAX, where it selects nothing either: the
    payload's shape (B, T, H, W, 3) alone takes the vector path. With no
    parameters the JAX ``variables`` argument of ``predict`` has no
    counterpart.
    """

    def __init__(self, cfg: Dict[str, Any], device: DeviceLike = None):
        m = cfg.get("model", {})
        self.only_this_ind: Optional[int] = m.get("only_this_ind")
        self.is_img = bool(m.get("is_img"))
        self.method = m.get("zbuffer_method", "auto")
        self.device = resolve_device(device)

    def predict(self, batch) -> Dict[str, torch.Tensor]:
        """batch["inputs"]: seg, depth, depth_mask (B, T, H, W[, C]),
        intrinsics (B, 3, 3), extrinsics (B, 4, 4), target_T (B, T, 4, 4),
        numpy arrays or tensors."""
        inp = batch["inputs"]
        seg, depth, depth_mask = (inp[k] for k in ("seg", "depth", "depth_mask"))
        target_T = torch.as_tensor(inp["target_T"], dtype=torch.float32)
        if self.only_this_ind is not None:
            i = self.only_this_ind
            seg, depth, depth_mask, target_T = (
                x[:, i : i + 1] for x in (seg, depth, depth_mask, target_T))
        height, width = depth.shape[-2:]
        return pc_transform_predict(
            seg, depth, depth_mask,
            torch.as_tensor(inp["intrinsics"], dtype=torch.float32),
            torch.as_tensor(inp["extrinsics"], dtype=torch.float32),
            target_T, height=height, width=width, method=self.method,
            device=self.device,
        )
