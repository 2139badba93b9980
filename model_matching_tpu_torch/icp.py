"""Point-to-plane ICP refinement of the winning pose.

Counterpart of ``model_matching_tpu/icp.py`` (``point_to_plane_icp``,
``trimmed_icp`` and ``refine_pose``): each iteration finds restricted-NN correspondences in
the scene's ICP grid and solves the small-angle linearization

    minimize sum_i ((R p_i + t - q_i) . n_i)^2,  R ~ I + [w]_x

through 6x6 normal equations, re-orthonormalized with Rodrigues' formula.
A fixed iteration count; no correspondences leave the offset at identity.
"""

from __future__ import annotations

import torch

from .ops import fmath
from .ops.gridhash import NeighborGrid, query_restricted_nn


def _solve_point_to_plane(src, tgt, nrm, w):
    """One linearized step; src/tgt/nrm [N, 3], w [N] weights. Returns a
    4x4 increment."""
    c = torch.linalg.cross(src, nrm, dim=-1)
    j = torch.cat([c, nrm], dim=-1)                 # [N, 6]
    r = ((tgt - src) * nrm).sum(-1)
    jw = j * w[:, None]
    eye6 = torch.eye(6, dtype=src.dtype, device=src.device)
    a = jw.T @ j + 1e-9 * eye6
    b = jw.T @ (r * w)
    x = torch.linalg.solve(a, b)
    wx, t = x[:3], x[3:]
    theta = torch.linalg.vector_norm(wx)
    k = wx / torch.clamp(theta, min=1e-12)
    zero = torch.zeros((), dtype=src.dtype, device=src.device)
    kx = torch.stack([
        torch.stack([zero, -k[2], k[1]]),
        torch.stack([k[2], zero, -k[0]]),
        torch.stack([-k[1], k[0], zero]),
    ])
    eye3 = torch.eye(3, dtype=src.dtype, device=src.device)
    sin, cos = fmath.sincos(theta)
    rot = eye3 + sin * kx + (1 - cos) * (kx @ kx)
    out = torch.eye(4, dtype=src.dtype, device=src.device)
    out[:3, :3] = rot
    out[:3, 3] = t
    return out


def point_to_plane_icp(source_pos, source_valid, target_pos, target_normal,
                       grid: NeighborGrid, max_corr_dist: float = 0.035,
                       iterations: int = 5):
    """4x4 offset transform aligning source [N, 3] onto target [S, 3]
    (identity when no correspondence is ever found)."""
    eye4 = torch.eye(4, dtype=source_pos.dtype, device=source_pos.device)
    offset = eye4
    for _ in range(iterations):
        moved = source_pos @ offset[:3, :3].T + offset[:3, 3]
        idx, _d2 = query_restricted_nn(grid, moved, target_pos, max_corr_dist)
        found = (idx >= 0) & source_valid
        safe = torch.clamp(idx, min=0).long()
        inc = _solve_point_to_plane(moved, target_pos[safe], target_normal[safe],
                                    found.to(moved.dtype))
        inc = torch.where(found.any(), inc, eye4)
        offset = inc @ offset
    return offset


def trimmed_icp(source_pos, source_valid, target_pos, target_normal,
                grid: NeighborGrid, max_corr_dist: float = 0.035,
                iterations: int = 5, trim_fraction: float = 0.8):
    """Trimmed point-to-plane ICP: each iteration keeps only the best
    `trim_fraction` of the correspondences by absolute residual (at least
    6), which makes the fit robust to partial overlap. Returns the 4x4
    offset; an iteration with fewer than 6 kept correspondences adds
    nothing."""
    eye4 = torch.eye(4, dtype=source_pos.dtype, device=source_pos.device)
    inf = torch.tensor(torch.inf, dtype=source_pos.dtype, device=source_pos.device)
    frac = torch.tensor(trim_fraction, dtype=torch.float32, device=source_pos.device)
    offset = eye4
    for _ in range(iterations):
        moved = source_pos @ offset[:3, :3].T + offset[:3, 3]
        idx, _d2 = query_restricted_nn(grid, moved, target_pos, max_corr_dist)
        found = (idx >= 0) & source_valid
        safe = torch.clamp(idx, min=0).long()
        tgt = target_pos[safe]
        nrm = target_normal[safe]
        res = torch.where(found, torch.abs(((tgt - moved) * nrm).sum(-1)), inf)
        # a float32 product truncated, at least 6
        n_keep = torch.clamp(
            (found.sum().to(torch.float32) * frac).to(torch.int32), min=6)
        # residual threshold = the n_keep-th smallest (inf for the unfound)
        order = torch.sort(res).values
        thresh = order[torch.clamp(n_keep, max=res.shape[0] - 1).long()]
        w = (found & (res <= thresh)).to(moved.dtype)
        inc = _solve_point_to_plane(moved, tgt, nrm, w)
        inc = torch.where(w.sum() >= 6, inc, eye4)
        offset = inc @ offset
    return offset


def refine_pose(pose, model_pos, model_valid, scene_grid: NeighborGrid,
                scene_pos, scene_normal, max_corr_dist: float = 0.035,
                iterations: int = 5):
    """Polish a centered-frame model->scene pose [4, 4]: ICP from the posed
    model onto the scene, the offset folded in."""
    moved = model_pos @ pose[:3, :3].T + pose[:3, 3]
    offset = point_to_plane_icp(moved, model_valid, scene_pos, scene_normal,
                                scene_grid, max_corr_dist, iterations)
    return offset @ pose
