"""Pose accuracy metrics: ADD / ADD-S, and the file-level evaluation behind
the CLI's `eval` command.

Counterpart of ``model_matching_tpu/eval.py``: the same metrics and
formulas (ADD-S through the matmul identity with the same 1e12 masking),
batched over poses, on torch tensors on the device of the caller's choice;
`model_diameter` and `read_pose_file` are numpy, as there. Estimates are
paired with ground truth by index when their counts are equal, as the JAX
package does.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import trace
from .utils.device import require


def _posed(pose, model_pos):
    """model_pos [M, 3] under poses [..., 4, 4] (or [..., 3, 4]) ->
    [..., M, 3]."""
    return model_pos @ pose[..., :3, :3].transpose(-1, -2) + pose[..., None, :3, 3]


def add_metric(pose_est, pose_gt, model_pos, model_valid=None):
    """ADD: mean distance between corresponding model points under the two
    poses (Hinterstoisser et al.)."""
    d = torch.linalg.norm(_posed(pose_est, model_pos) - _posed(pose_gt, model_pos), dim=-1)
    if model_valid is not None:
        w = model_valid.to(d.dtype)
        return (d * w).sum(-1) / torch.clamp(w.sum(), min=1.0)
    return d.mean(-1)


def adds_metric(pose_est, pose_gt, model_pos, model_valid=None):
    """ADD-S: mean closest-point distance, the symmetric-object variant
    (each gt-posed point matches its nearest est-posed point)."""
    est = _posed(pose_est, model_pos)
    gt = _posed(pose_gt, model_pos)
    # [..., Mgt, Mest] squared distances via the matmul identity
    e2 = (est * est).sum(-1)
    g2 = (gt * gt).sum(-1)
    cross = torch.einsum("...ik,...jk->...ij", gt, est)
    d2 = g2[..., :, None] + e2[..., None, :] - 2.0 * cross
    if model_valid is not None:
        d2 = torch.where(model_valid[None, :], d2, torch.tensor(1e12, dtype=d2.dtype,
                                                                 device=d2.device))
        dmin = torch.sqrt(torch.clamp(d2.amin(-1), min=0.0))
        w = model_valid.to(dmin.dtype)
        return (dmin * w).sum(-1) / torch.clamp(w.sum(), min=1.0)
    return torch.sqrt(torch.clamp(d2.amin(-1), min=0.0)).mean(-1)


def adds_accuracy(pose_est, pose_gt, model_pos, model_diameter,
                  threshold_fraction: float = 0.1, model_valid=None):
    """The standard pass criterion: ADD-S < threshold_fraction * diameter."""
    return adds_metric(pose_est, pose_gt, model_pos, model_valid) < (
        threshold_fraction * model_diameter)


def model_diameter(pos) -> float:
    """Max pairwise distance over the model points. Exact for <= 4096
    points; beyond that the candidates are the extremes along 512 seeded
    directions (the diameter is attained at hull vertices, each extreme
    along some direction)."""
    p = np.asarray(pos, np.float64)
    if p.shape[0] > 4096:
        rng = np.random.default_rng(0)
        dirs = rng.normal(size=(512, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        proj = p @ dirs.T
        cand = np.unique(np.concatenate([proj.argmax(axis=0), proj.argmin(axis=0)]))
        p = p[cand]
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(d2.max()))


def read_pose_file(path: str):
    """Parse a pose artifact: one pose per line, 12 floats (row-major 3x4,
    the best_pose_candidate format) or 16 (4x4); a trailing 13th/17th float
    (the clustered_poses score column) is ignored. Returns [K, 4, 4]
    float32."""
    poses = []
    with open(path) as f:
        for ln in f:
            vals = [float(v) for v in ln.split()]
            if not vals:
                continue
            if len(vals) in (13, 17):
                vals = vals[:-1]
            if len(vals) == 12:
                m = np.eye(4)
                m[:3, :] = np.asarray(vals).reshape(3, 4)
            elif len(vals) == 16:
                m = np.asarray(vals).reshape(4, 4)
            else:
                raise ValueError(
                    f"{path}: expected 12 or 16 floats per line "
                    f"(+optional score), got {len(vals)}"
                )
            poses.append(m)
    if not poses:
        raise ValueError(f"{path}: no poses found")
    return np.stack(poses).astype(np.float32)


def evaluate_poses(est: np.ndarray, gt: np.ndarray, model_pos,
                   threshold_fraction: float = 0.1,
                   diameter: float | None = None, device="cuda") -> dict:
    """ADD / ADD-S / pass-rate for pose arrays [K, 4, 4], the metrics run
    on `device`. Equal counts pair by index; otherwise each estimate is
    scored against its best-matching ground-truth instance (a single GT
    pose thereby broadcasts; several are the instances of a BOP image).
    Returns a JSON-ready dict."""
    dev = require(device)
    est = np.asarray(est, np.float32).reshape(-1, 4, 4)
    gt = np.asarray(gt, np.float32).reshape(-1, 4, 4)
    mp = torch.from_numpy(np.asarray(model_pos, np.float32)).to(dev)
    dia = model_diameter(model_pos) if diameter is None else float(diameter)
    e, g = torch.from_numpy(est).to(dev), torch.from_numpy(gt).to(dev)
    if gt.shape[0] == est.shape[0]:
        add, adds = add_metric(e, g, mp), adds_metric(e, g, mp)
    else:
        # [E, G] metric matrices, the minimum over the GT instances
        add = add_metric(e[:, None], g[None, :], mp).amin(1)
        adds = adds_metric(e[:, None], g[None, :], mp).amin(1)
    trace.count("host_reads", 2)
    add, adds = (a.cpu().numpy() for a in (add, adds))
    thr = threshold_fraction * dia
    return {
        "num_poses": int(est.shape[0]),
        "num_gt": int(gt.shape[0]),
        "model_diameter": dia,
        "threshold": float(thr),
        "threshold_fraction": float(threshold_fraction),
        "add": [float(v) for v in add],
        "adds": [float(v) for v in adds],
        "add_mean": float(add.mean()),
        "adds_mean": float(adds.mean()),
        "add_pass_rate": float((add < thr).mean()),
        "adds_pass_rate": float((adds < thr).mean()),
    }


def evaluate_pose_files(est_path: str, gt_path: str, model_pos,
                        threshold_fraction: float = 0.1,
                        diameter: float | None = None,
                        gt_poses: np.ndarray | None = None,
                        device="cuda") -> dict:
    """ADD / ADD-S / pass-rate for the pose(s) in `est_path` against
    `gt_path` (same line-per-pose format; a single GT line broadcasts over
    several estimates), or against `gt_poses` directly (the BOP
    scene_gt.json route, io/bop.py). Returns a JSON-ready dict."""
    est = read_pose_file(est_path)
    gt = gt_poses if gt_poses is not None else read_pose_file(gt_path)
    gt = np.asarray(gt, np.float32).reshape(-1, 4, 4)
    if est.shape[0] != gt.shape[0] and gt.shape[0] != 1 and gt_poses is None:
        raise ValueError(
            f"pose count mismatch: {est_path} has {est.shape[0]}, "
            f"{gt_path} has {gt.shape[0]}"
        )
    return evaluate_poses(est, gt, model_pos, threshold_fraction=threshold_fraction,
                          diameter=diameter, device=device)
