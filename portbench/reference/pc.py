"""Plain reprojection and z-buffer (the public ``PCTransformModel.predict``,
pc_transform_model.py): every pixel of each past frame is lifted with its
depth, moved by the camera chain ``A = E⁻¹·target_T·E`` and projected
into the target camera; each point splats to its four surrounding
integer pixels (floor/ceil, clamped into the image); the nearest wins.

Semantics kept from the public code: a point is valid with valid input
depth, z > 0 and on screen; invalid points still splat, with label 0 and
the frame's sentinel depth ``max(valid z) + 1``; untouched pixels get
label 0 and depth -1; the winner's depth keeps its float's top 24 bits
and ties go to the smallest label (the packed key of the TPU code, which
the public forecast's outputs were made with). The camera chain and the
per-pixel lift round as the public code's float32 computation does on
the CPU (below).
"""

from __future__ import annotations

import numpy as np
import torch


# A frozen copy of the JAX semantics' float32 rounding of the camera chain
# and the per-pixel lift (XLA's LAPACK inverse, its dot order and fused
# multiply-adds on the CPU), so that a point lands on the pixels the
# public code's exports put it on.

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


def splat(seg, depth, dmask, K, E, T, height: int, width: int):
    """One frame: seg/depth/dmask (H, W) on the device, K (3, 3), E and T
    (4, 4) numpy -> (label (H, W) int32, depth (H, W) f32)."""
    dev = depth.device
    f32 = torch.float32
    uv, z = _reproject_points(depth.to(f32)[None, None],
                              torch.as_tensor(np.asarray(K), dtype=f32)[None],
                              torch.as_tensor(np.asarray(E), dtype=f32)[None],
                              torch.as_tensor(np.asarray(T), dtype=f32)[None, None],
                              height, width)
    pu, pv, z = uv[0, 0, ..., 0], uv[0, 0, ..., 1], z[0, 0]
    valid = dmask.bool() & (z > 0) & (pu >= 0) & (pu < width) & (pv >= 0) & (pv < height)
    top = torch.where(valid, z, -float("inf")).max()
    sentinel = (top if torch.isfinite(top) else torch.zeros_like(top)) + 1.0
    zz = torch.where(valid, z, sentinel).float()
    lab = torch.where(valid, seg.long(), 0)
    key = (zz.view(torch.int32).long() & ~0xFF) | (lab & 0xFF)

    def corners(p, n):
        p = torch.nan_to_num(p, nan=0.0, posinf=float(n), neginf=-1.0).clamp(-1.0, float(n))
        return [torch.floor(p).long().clamp(0, n - 1), torch.ceil(p).long().clamp(0, n - 1)]

    us, vs = corners(pu, width), corners(pv, height)
    canvas = torch.full((height * width,), 2**62, dtype=torch.long, device=dev)
    for cu in us:
        for cv in vs:
            canvas.scatter_reduce_(0, (cv * width + cu).reshape(-1), key.reshape(-1), "amin")
    hit = canvas != 2**62
    label = torch.where(hit, canvas & 0xFF, 0).to(torch.int32)
    zbits = torch.where(hit, canvas & ~0xFF, 0).to(torch.int32)
    out_depth = torch.where(hit, zbits.view(torch.float32), -1.0)
    return label.view(height, width), out_depth.view(height, width)
