"""Surface normal estimation.

Counterpart of ``model_matching_tpu/ops/normals.py``:

* `grid_pca_normals` — radius-PCA normals over a padded cloud (the scene's
  default `scene_normal_mode="cloud_pca"` and model preprocessing);
* `depth_normals` — cv::rgbd::RgbdNormals' LINEMOD method on a depth image
  (`scene_normal_mode="depth"`);
* `pca_normals_from_neighbors` + `radius_neighbor_indices` — PCA normals
  from host-side neighbour lists.

The covariance E[p p^T] - mean mean^T of a few points a metre from the
camera cancels all but a few bits of float32, so the normal depends on the
exact rounding of its moments. `grid_pca_normals` therefore accumulates
the moments in float32 in the JAX package's order (neighbour cell after
neighbour cell, member after member) and forms the covariance with the
same fused multiply-add; the float32 eigen-solve then repeats the JAX
package's expression with its rounding (ops/fmath.py for acos and cos).
Every step is correctly rounded, so the card gives the CPU's bits, and the
normals are the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import fmath
from .fp import div, div_const, dot3, f32, fma, mul_recip, sqrt_rn, xla_sum0
from .voxel import _longest_run, neighbor_blocks


def _cross_fused(a, b):
    """a x b with each component as fma(a_i, b_j, -(a_j b_i)), the
    contraction of the JAX package's compiled cross product."""
    def comp(i, j):
        return fma(a[..., i], b[..., j], -(a[..., j] * b[..., i]))

    return torch.stack([comp(1, 2), comp(2, 0), comp(0, 1)], dim=-1)


def depth_normals(depth, fx, cx, fy, cy, window: int = 5,
                  diff_threshold: float = 50.0):
    """Normals [H, W, 3] + validity [H, W] from a depth image, transcribing
    cv::rgbd::RgbdNormals' LINEMOD method as the JAX package does: a fixed
    3x3 sample grid at +-5 pixels (OpenCV ignores `window`), samples with
    |delta| > diff_threshold (raw units) dropped, the coupled 2x2 least-
    squares depth gradient, the cross product of the back-projection's
    tangents, flipped camera-facing on z; pixels within 5 of the left/top or
    6 of the right/bottom border, rank-deficient patterns and zero depths
    are invalid."""
    h, w = depth.shape
    z = depth.to(torch.float32)
    r = 5
    zpad = torch.nn.functional.pad(z, (r, r, r, r))
    sxx = torch.zeros_like(z)
    syy = torch.zeros_like(z)
    sxy = torch.zeros_like(z)
    bx = torch.zeros_like(z)
    by = torch.zeros_like(z)
    for oy in (-r, 0, r):
        for ox in (-r, 0, r):
            delta = zpad[oy + r:oy + r + h, ox + r:ox + r + w] - z
            acc = torch.abs(delta) <= diff_threshold
            af = acc.to(torch.float32)
            sxx = sxx + af * float(ox * ox)
            syy = syy + af * float(oy * oy)
            sxy = sxy + af * float(ox * oy)
            bx = bx + torch.where(acc, float(ox) * delta, 0.0)
            by = by + torch.where(acc, float(oy) * delta, 0.0)

    det = fma(sxx, syy, -(sxy * sxy))
    ok_det = det > 0.5
    safe_det = torch.where(ok_det, det, 1.0)
    zu = fma(syy, bx, -(sxy * by)) / safe_det
    zv = fma(sxx, by, -(sxy * bx)) / safe_det

    rows = torch.arange(h, dtype=torch.float32, device=z.device)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.float32, device=z.device)[None, :].expand(h, w)
    ucx = cols - f32(cx)
    vcy = rows - f32(cy)
    tu = torch.stack([mul_recip(fma(ucx, zu, z), fx), mul_recip(vcy * zu, fy), zu], -1)
    tv = torch.stack([mul_recip(ucx * zv, fx), mul_recip(fma(vcy, zv, z), fy), zv], -1)
    n = _cross_fused(tu, tv)
    norm = sqrt_rn(dot3(n, n))[..., None]

    border = (rows >= r) & (rows <= h - r - 2) & (cols >= r) & (cols <= w - r - 2)
    ok = border & (z > 0) & ok_det & (norm[..., 0] > 1e-12)
    n = torch.where(ok[..., None], n / torch.clamp(norm, min=1e-12), 0.0)
    flip = n[..., 2] > 0
    n = torch.where(flip[..., None], -n, n)
    return n, ok


def smallest_eigenvector_3x3(cov, fused: bool = True):
    """Unit eigenvector of the smallest eigenvalue of symmetric [..., 3, 3]
    float32 matrices: the analytic trigonometric eigenvalue, then the
    largest cross product of two rows of A - lambda I (+z for isotropic
    matrices), in float32 with the JAX package's rounding. `fused` picks
    its compiled scene program (divisions by constants as products with
    the rounded reciprocal, the multiply-adds XLA contracts, p^3 as
    max(p^2, 1e-30) * p); False its op-by-op model preprocessing (true
    divisions, no contraction between jnp calls, p^3 = p * (p * p))."""
    a = cov.to(torch.float32)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    tr = (a[..., 0, 0] + a[..., 1, 1]) + a[..., 2, 2]
    div3 = (lambda x: mul_recip(x, 3.0)) if fused else (lambda x: div_const(x, 3.0))
    q = div3(tr)
    b = a - q[..., None, None] * eye
    bf = b.flatten(-2)
    if fused:
        # the reduction's multiply-adds contracted, in row-major order
        p2s = bf[..., 0] * bf[..., 0]
        for k in range(1, 9):
            p2s = fma(bf[..., k], bf[..., k], p2s)
    else:
        sq = bf * bf
        p2s = sq[..., 0]
        for k in range(1, 9):
            p2s = p2s + sq[..., k]
    pc = torch.clamp(mul_recip(p2s, 6.0) if fused else div_const(p2s, 6.0), min=1e-30)
    p = sqrt_rn(pc)
    b00, b01, b02 = b[..., 0, 0], b[..., 0, 1], b[..., 0, 2]
    b10, b11, b12 = b[..., 1, 0], b[..., 1, 1], b[..., 1, 2]
    b20, b21, b22 = b[..., 2, 0], b[..., 2, 1], b[..., 2, 2]
    # jnp.linalg.det's six triple products, its first sum fusing the first
    det = fma(b00 * b11, b22, (b01 * b12) * b20)
    det = fma(b02 * b10, b21, det)
    det = fma(-(b02 * b11), b20, det)
    det = fma(-(b00 * b12), b21, det)
    det = fma(-(b01 * b10), b22, det)
    p3 = pc * p if fused else p * (p * p)
    c = torch.clamp(div(det, p3 * 2.0), -1.0, 1.0)
    ac = fmath.acos(c)
    two_pi_3 = f32(2.0 * math.pi / 3.0)
    if fused:
        # phi + 2 pi / 3 and q + 2 p cos(.) each contract their first product
        third = torch.full_like(ac, f32(1.0 / 3.0))
        cs = fmath.cos(fma(ac, third, torch.full_like(ac, two_pi_3)))
        eig = fma(tr, third, (p * 2.0) * cs)
    else:
        cs = fmath.cos(div3(ac) + two_pi_3)
        eig = q + (p * 2.0) * cs
    m = a - eig[..., None, None] * eye
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    cands = torch.stack([_cross_fused(r0, r1), _cross_fused(r0, r2),
                         _cross_fused(r1, r2)], dim=-2)
    norms = sqrt_rn(dot3(cands, cands))
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    vn = sqrt_rn(dot3(v, v))[..., None]
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=a.dtype, device=a.device).expand(v.shape)
    return torch.where(vn > 1e-12, div(v, torch.clamp(vn, min=1e-12)), fallback)


def grid_pca_normals(pos, valid, radius: float, cell_cap: int = 64,
                     min_neighbors: int = 3, orient: str = "camera",
                     fused: bool = True):
    """Radius-PCA normals over a padded cloud through a sorted voxel grid
    (cell = radius, 27 neighbour cells of at most `cell_cap` members):
    the moments of the neighbours within `radius`, then the smallest
    covariance eigenvector. orient="camera" points normals toward the
    origin (n . p < 0, the scene convention), "outward" away from it (the
    model convention). Returns (normal [N, 3], ok [N]).

    `fused` picks the JAX package's rounding: True as in its compiled scene
    program (the cell index through the reciprocal of `radius`, the
    covariance with a fused multiply-add), False as in model preprocessing,
    which runs the same function op by op (a true division, an unfused
    covariance)."""
    n = pos.shape[0]
    dev = pos.device
    origin = torch.where(valid[:, None], pos, 3.0e38).amin(dim=0)
    scaled = (mul_recip(pos - origin, radius) if fused
              else div_const(pos - origin, radius))
    ijk = torch.clamp(torch.floor(scaled).to(torch.int32), 0, 1023).to(torch.int64)
    key = torch.where(valid, (ijk[..., 0] * 1024 + ijk[..., 1]) * 1024 + ijk[..., 2],
                      2**31 - 1)
    key_s, order = torch.sort(key, stable=True)
    pos_s = pos[order]
    r2 = f32(radius * radius)
    width = _longest_run(key_s, cell_cap)

    cnt = torch.zeros(n, dtype=torch.float32, device=dev)
    s1 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    s2 = torch.zeros((n, 3, 3), dtype=torch.float32, device=dev)
    for members, in_cell in neighbor_blocks(pos, key, key_s, pos_s, cell_cap, width):
        diff = pos[:, None, :] - members
        take = in_cell & (dot3(diff, diff) <= r2)                  # [N, width]
        outer = members[..., :, None] * members[..., None, :]      # [N, width, 3, 3]
        # float32 sums member after member, as the JAX package's loop adds
        for j in range(width):
            t = take[:, j]
            cnt = cnt + t.to(torch.float32)
            s1 = torch.where(t[:, None], s1 + members[:, j], s1)
            s2 = torch.where(t[:, None, None], s2 + outer[:, j], s2)

    denom = torch.clamp(cnt, min=1.0)
    mean = s1 / denom[:, None]
    e2 = s2 / denom[:, None, None]
    if fused:
        cov = fma(-mean[:, :, None], mean[:, None, :], e2)
    else:
        cov = e2 - mean[:, :, None] * mean[:, None, :]
    nrm = smallest_eigenvector_3x3(cov, fused=fused)
    dot = dot3(nrm, pos)
    flip = dot > 0 if orient == "camera" else dot < 0
    nrm = torch.where(flip[:, None], -nrm, nrm)
    ok = valid & (cnt >= min_neighbors)
    return torch.where(ok[:, None], nrm, 0.0), ok


def radius_neighbor_indices(pos: np.ndarray, radius: float, cap: int):
    """Host-side neighbour search for offline model preprocessing: padded
    [N, cap] int32 indices (-1 padding) + [N] counts, self included."""
    from scipy.spatial import cKDTree

    tree = cKDTree(pos)
    idx = np.full((pos.shape[0], cap), -1, dtype=np.int32)
    counts = np.zeros(pos.shape[0], dtype=np.int32)
    for i, nbrs in enumerate(tree.query_ball_point(pos, radius)):
        k = min(len(nbrs), cap)
        idx[i, :k] = nbrs[:k]
        counts[i] = k
    return idx, counts


def pca_normals_from_neighbors(pos, nbr_idx, nbr_count, orient_outward_from_origin):
    """Batched PCA normals from padded neighbour lists: pos [N, 3],
    nbr_idx [N, cap] (-1 padding), nbr_count [N]. Oriented outward from the
    origin (n . p >= 0) or toward it; NaN where fewer than 3 neighbours.

    Rounds as the JAX function's compiled program: the mean sums the masked
    neighbours in XLA's reduction order (`fp.xla_sum0`) and divides by the
    count; the covariance is XLA's loop over the neighbours, one fused
    multiply-add each from zero, then a true division by the count; the
    orientation test is the contracted 3-term dot product. Bit-equal to the
    jitted JAX function (tests/test_torch_ingest.py)."""
    cap = nbr_idx.shape[1]
    mask = torch.arange(cap, device=pos.device)[None, :] < nbr_count[:, None]
    nbrs = pos[torch.clamp(nbr_idx, min=0).long()]                 # [N, cap, 3]
    cnt = torch.clamp(nbr_count.to(pos.dtype), min=1.0)[:, None]
    mean = div(xla_sum0(torch.where(mask[..., None], nbrs, 0.0).transpose(0, 1)), cnt)
    centered = (nbrs - mean[:, None, :]) * mask[..., None].to(pos.dtype)
    outer = torch.zeros((pos.shape[0], 3, 3), dtype=pos.dtype, device=pos.device)
    for k in range(cap):
        c = centered[:, k]
        outer = fma(c[:, :, None], c[:, None, :], outer)
    cov = div(outer, cnt[..., None])
    nrm = smallest_eigenvector_3x3(cov)
    sign = dot3(nrm, pos)[:, None]
    if orient_outward_from_origin:
        nrm = torch.where(sign < 0, -nrm, nrm)
    else:
        nrm = torch.where(sign > 0, -nrm, nrm)
    return torch.where((nbr_count < 3)[:, None], torch.nan, nrm)
