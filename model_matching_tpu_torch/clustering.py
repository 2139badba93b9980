"""Hypothesis post-processing: symmetry-aware greedy pose clustering.

Counterpart of ``model_matching_tpu/clustering.py``: quaternion and Euler
conversions, the symmetry-reduced pose difference, and greedy clustering
(prune below acceptable_fraction * best, walk the candidates by descending
LCP, reject any pose within both thresholds of an accepted one, stop once
the accepted count exceeds the cap).

The JAX package walks all H sorted candidates one by one inside a compiled
loop. Here the walk takes at most `maximum_pose_count + 1` steps: each
step accepts the best-scored candidate not yet rejected and rejects, in
one batch over all H, every candidate within both thresholds of it. A
candidate is rejected exactly when it clashes with a pose accepted before
its turn, so the accepted sequence is the same.
"""

from __future__ import annotations

import math

import torch

from .ops import fmath
from .ops.fp import dot3, sqrt_rn

_RAD2DEG = 180.0 / math.pi


def matrix_to_quaternion(r):
    """Rotation matrix [..., 3, 3] -> quaternion (w, x, y, z), Shepperd's
    method: of the four formulations, the one with the largest pivot."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return sqrt_rn(torch.clamp(x, min=1e-12))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    c0 = torch.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
         (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    c1 = torch.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
         (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    c2 = torch.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
         (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    c3 = torch.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
         (m12 + m21) / (4 * qz3), qz3], dim=-1)

    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    pick = best[..., None, None].expand(best.shape + (1, 4))
    return torch.gather(cands, -2, pick)[..., 0, :]


def quaternion_to_euler(q):
    """(w, x, y, z) -> (roll, pitch, yaw) radians, with the gimbal branch
    (pitch = copysign(pi / 2) when |sin| >= 1)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr = 2.0 * (w * x + y * z)
    cosr = 1.0 - 2.0 * (x * x + y * y)
    sinp = 2.0 * (w * y - z * x)
    siny = 2.0 * (w * z + x * y)
    cosy = 1.0 - 2.0 * (y * y + z * z)
    # roll, asin(sinp) / 2 and yaw through one atan2
    py, px = fmath.asin_atan2_args(torch.clamp(sinp, -1.0, 1.0))
    roll, half_pitch, yaw = fmath.atan2(torch.stack([sinr, py, siny]),
                                        torch.stack([cosr, px, cosy]))
    pitch = torch.where(
        torch.abs(sinp) >= 1.0,
        torch.sign(sinp) * (math.pi / 2.0),
        half_pitch + half_pitch,
    )
    return torch.stack([roll, pitch, yaw], dim=-1)


def pose_difference(test_pose, base_pose, sym_info):
    """(max per-axis symmetry-reduced rotation error [deg], translation
    error) between 4x4 poses (broadcastable). sym_info [3]: 0 / 90 / 180 /
    360 per axis. The relative rotation is test^T @ base, in this order:
    the absolute Euler angles of a rotation and of its inverse differ. Its
    nine entries are fixed-order fused products (ops/fp.dot3), not a batched
    matmul, so the card and the CPU round them alike."""
    rt = test_pose[..., :3, :3].transpose(-1, -2)        # rows: test's columns
    bt = base_pose[..., :3, :3].transpose(-1, -2)        # rows: base's columns
    rdiff = dot3(rt[..., :, None, :], bt[..., None, :, :])
    e = torch.abs(quaternion_to_euler(matrix_to_quaternion(rdiff)) * _RAD2DEG)

    e90 = torch.minimum(torch.abs(e - 90.0), 90.0 - torch.abs(e - 90.0))
    e180 = torch.minimum(e, 180.0 - e)
    e = torch.where(sym_info == 90.0, e90, e)
    e = torch.where(sym_info == 180.0, e180, e)
    e = torch.where(sym_info == 360.0, 0.0, e)
    rot_err = e.amax(dim=-1)
    d = test_pose[..., :3, 3] - base_pose[..., :3, 3]
    return rot_err, sqrt_rn(dot3(d, d))


def greedy_clustering(
    transforms: torch.Tensor,   # [H, 4, 4]
    lcp: torch.Tensor,          # [H]
    valid: torch.Tensor,        # [H]
    acceptable_fraction: float,
    best_score,                 # 0-dim float32 tensor or float
    maximum_pose_count: int,
    min_distance: float,
    min_angle: float,
    sym_info: torch.Tensor,     # [3]
):
    """Returns (selected indices [K] into transforms (-1 padding), selected
    mask [K]), K = maximum_pose_count + 1 (the walk stops after the cap is
    exceeded). Candidates must score strictly above acceptable_fraction *
    best_score; among equal scores the lower index goes first. No host
    read."""
    dev = transforms.device
    k = maximum_pose_count + 1
    best_score = torch.as_tensor(best_score, dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(-torch.inf, dtype=lcp.dtype, device=dev)
    score = torch.where(valid & (lcp > acceptable_fraction * best_score),
                        lcp, neg_inf)
    accepted = []
    for _ in range(k):
        cand = torch.argmax(score)                 # first maximum
        ok = score[cand] > neg_inf
        accepted.append(torch.where(ok, cand, -1))
        rot_err, t_err = pose_difference(transforms, transforms[cand], sym_info)
        clash = (rot_err < min_angle) & (t_err < min_distance)
        score = torch.where(clash, neg_inf, score)
        # the accepted pose leaves the walk whatever its difference to itself
        score = score.index_fill(0, cand.reshape(1), -torch.inf)
    accepted_idx = torch.stack(accepted).to(torch.int32)
    return accepted_idx, accepted_idx >= 0
