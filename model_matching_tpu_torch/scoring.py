"""Weighted-LCP hypothesis scoring.

Counterpart of ``model_matching_tpu/scoring.py``. A hypothesis scores the
sum of the class probabilities of the scene points matched by its posed
model points (restricted NN within the distance threshold, normals within
the angle gate), divided by the model size. Two scene structures serve the
queries: the exact voxel-grid hash (ops/gridhash.py) and the dense NN
field (ops/densefield.py); ``score_hybrid`` composes them into the
three-stage ladder — field + model subset for every hypothesis, field +
full model for the top fraction, exact grid for the leaders.

The distance and normal sums follow the JAX package's contracted rounding
(ops/fp.py): a gate flip at the threshold would move a score by a whole
point's weight. The weight sums accumulate in float64 and round once to
float32 (``_weight_sum``): the ladder ranks thousands of hypotheses whose
scores are sums of the same few class probabilities, so many tie exactly,
and a float32 sum in a device-dependent order would break those ties
differently on the CPU and on a GPU.
"""

from __future__ import annotations

import functools
import math

import torch

from .ops import fmath
from .ops.densefield import DenseField, field_lookup
from .ops.fp import dot3
from .utils import trace
from .ops.gridhash import (
    NeighborGrid,
    query_restricted_nn_normal,
    query_restricted_nn_scored,
)


@functools.lru_cache(maxsize=None)
def _cos_gate_value(normal_angle_threshold_deg: float) -> float:
    """cos of the threshold as the JAX package rounds it, evaluated once
    on the CPU (the same bits as on the card)."""
    return float(fmath.cos(torch.tensor(normal_angle_threshold_deg * (math.pi / 180.0),
                                        dtype=torch.float32)))


def _cos_gate(normal_angle_threshold_deg, device):
    return torch.full((), _cos_gate_value(normal_angle_threshold_deg),
                      dtype=torch.float32, device=device)


def _weight_sum(w):
    """Sum over the last axis, accumulated in float64 and rounded once to
    float32: exact, so independent of the reduction order, while the
    weights' binary exponents span fewer than ~29 bits (class
    probabilities above 2^-20 over up to 2^9 points)."""
    return w.sum(-1, dtype=torch.float64).to(torch.float32)


def _rotate(rot, v):
    """[H, 3, 3] rotations applied to [M, 3] vectors -> [H, M, 3], as
    fixed-order fused chains (ops/fp.dot3) rather than a batched matmul,
    whose rounding order depends on the library and the device."""
    return dot3(rot[:, None], v[None, :, None, :])


def _pose(transforms, model_pos):
    rot = transforms[:, :3, :3]
    return rot, _rotate(rot, model_pos) + transforms[:, None, :3, 3]


def score_transforms_field(transforms, valid, model_pos, model_normal,
                           model_valid, field: DenseField, scene_class_prob,
                           distance_threshold, normal_angle_threshold_deg,
                           model_count=None):
    """Fast-path weighted LCP through the dense NN field: one row read per
    (hypothesis, model point). `scene_class_prob=None` reads the weight from
    the field row (a field built with prob=)."""
    cos_gate = _cos_gate(normal_angle_threshold_deg, transforms.device)
    if model_count is None:
        model_count = model_valid.to(torch.float32).sum()
    rot, q = _pose(transforms, model_pos)
    cand_pos, cand_nrm, cand_idx, occ, s7 = field_lookup(field, q)
    diff = q - cand_pos
    d2 = dot3(diff, diff)
    nq = _rotate(rot, model_normal)
    cos = dot3(cand_nrm, nq)
    if scene_class_prob is None:
        if not field.has_probs:
            raise ValueError(
                "scene_class_prob=None needs a field built with prob= "
                "(see ops/densefield.build_dense_field)"
            )
        pw = torch.clamp(s7, min=0.0)
    else:
        pw = scene_class_prob[cand_idx.long()]
    gate = (occ & (d2 <= distance_threshold * distance_threshold)
            & (cos > cos_gate) & model_valid[None, :])
    w = torch.where(gate, pw, 0.0)
    scores = _weight_sum(w) / torch.clamp(model_count, min=1.0)
    return torch.where(valid, scores, -1.0)


def score_transforms(transforms, valid, model_pos, model_normal, model_valid,
                     grid: NeighborGrid, scene_pos, scene_normal,
                     scene_class_prob, distance_threshold,
                     normal_angle_threshold_deg, model_count=None,
                     chunk: int = 0):
    """Exact weighted LCP per transform through the voxel-grid hash,
    `chunk` hypotheses at a time (0 = all at once). `scene_class_prob=None`
    reads the winner's normal and weight from the payload row."""
    cos_gate = _cos_gate(normal_angle_threshold_deg, transforms.device)
    if model_count is None:
        model_count = model_valid.to(torch.float32).sum()

    def score_chunk(tr):
        rot, q = _pose(tr, model_pos)
        if scene_class_prob is None:
            idx, _d2, cand_nrm, wprob = query_restricted_nn_scored(
                grid, q, distance_threshold)
            wprob = torch.clamp(wprob, min=0.0)
        else:
            idx, _d2, cand_nrm = query_restricted_nn_normal(
                grid, q, scene_pos, scene_normal, distance_threshold)
            wprob = scene_class_prob[torch.clamp(idx, min=0).long()]
        nq = _rotate(rot, model_normal)
        cos = dot3(cand_nrm, nq)
        gate = (idx >= 0) & (cos > cos_gate) & model_valid[None, :]
        w = torch.where(gate, wprob, 0.0)
        return _weight_sum(w) / torch.clamp(model_count, min=1.0)

    if chunk and transforms.shape[0] > chunk:
        scores = torch.cat([score_chunk(transforms[i:i + chunk])
                            for i in range(0, transforms.shape[0], chunk)])
    else:
        scores = score_chunk(transforms)
    return torch.where(valid, scores, -1.0)


def exact_score_chunk(configured: int, model_points: int, cell_cap: int) -> int:
    """Hypothesis chunk for exact scoring: the configured value, or the
    largest multiple of 256 whose [chunk, M, cell_cap, 8] f32 payload
    transient stays under 640 Mi elements (2.5 GiB)."""
    if configured:
        return configured
    c = (640 * 1024 * 1024) // max(1, model_points * cell_cap * 8)
    return int(max(256, min(8192, (c // 256) * 256)))


def best_pose(scores):
    """Argmax with the reference's strict-greater scan: index -1 unless
    some score > 0 (torch.argmax returns the first maximum)."""
    best_idx = torch.argmax(scores)
    best = scores[best_idx]
    return (torch.where(best > 0, best_idx, -1).to(torch.int32),
            torch.clamp(best, min=0.0))


def _top_k(x, k):
    """lax.top_k's order: values descending, ties by ascending index."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _stable_partition_sel(valid, cap: int):
    """First `cap` slot indices of the stable valid-first partition."""
    return torch.sort((~valid).to(torch.int8), stable=True).indices[:cap]


def run_bucketed(count, cap: int, fn_at_width):
    """Run `fn_at_width(width)` at the smallest width in (cap/8, cap/4,
    cap/2, cap) that covers `count` (one host read). Every live slot sits
    in the partition prefix, so the narrower run padded with dead slots
    equals the full-width run."""
    trace.count("host_reads")
    n = int(count)
    for wd in (cap // 8, cap // 4, cap // 2):
        if n <= wd:
            return fn_at_width(wd)
    return fn_at_width(cap)


def score_hybrid(transforms, valid, model_pos, model_normal, model_valid,
                 field: DenseField, grid: NeighborGrid, scene_pos,
                 scene_normal, scene_class_prob, distance_threshold,
                 normal_angle_threshold_deg, model_count=None,
                 coarse_points: int = 64, mid_fraction: float = 0.08,
                 mid_cap: int = 4096, refine_count: int = 256,
                 compact_cap: int = 0, bucket_stage1: bool = True,
                 precompacted_count=None):
    """Production scorer, a three-stage ladder: (1) dense field over a
    strided model subset for every hypothesis, (2) dense field over the
    full model for the top fraction (capped at mid_cap), (3) exact grid for
    the top refine_count. Non-leaders report -1.

    `compact_cap`: past it, valid slots are stably partitioned to the
    front and only the first `compact_cap` are scored. `precompacted_count`
    is the partition-prefix length when the caller already compacted."""
    h_orig = transforms.shape[0]
    sel = None
    if compact_cap and h_orig > compact_cap:
        sel = _stable_partition_sel(valid, compact_cap)
        transforms = transforms[sel]
        valid = valid[sel]
    h = transforms.shape[0]
    m = model_pos.shape[0]
    sub = slice(0, m, max(1, m // coarse_points))

    frac = int(h * mid_fraction)
    if mid_cap:
        frac = min(frac, mid_cap)
    k_mid = min(h, max(refine_count, frac))

    def stage1_at(width):
        c = score_transforms_field(
            transforms[:width], valid[:width], model_pos[sub],
            model_normal[sub], model_valid[sub], field, scene_class_prob,
            distance_threshold, normal_angle_threshold_deg,
        )
        return _top_k(c, k_mid)

    compacted = sel is not None or precompacted_count is not None
    if bucket_stage1 and compacted and h >= 8192 and h // 8 >= k_mid:
        nv = (precompacted_count if precompacted_count is not None
              else valid.sum(dtype=torch.int32))
        _t, mid_idx = run_bucketed(nv, h, stage1_at)
    else:
        _t, mid_idx = stage1_at(h)
    mid = score_transforms_field(
        transforms[mid_idx], valid[mid_idx], model_pos, model_normal,
        model_valid, field, scene_class_prob, distance_threshold,
        normal_angle_threshold_deg, model_count=model_count,
    )
    _t, fine_rel = _top_k(mid, min(k_mid, refine_count))
    fine_idx = mid_idx[fine_rel]
    fine = score_transforms(
        transforms[fine_idx], valid[fine_idx], model_pos, model_normal,
        model_valid, grid, scene_pos, scene_normal, scene_class_prob,
        distance_threshold, normal_angle_threshold_deg, model_count=model_count,
    )
    out = torch.full((h_orig,), -1.0, dtype=fine.dtype, device=fine.device)
    if sel is not None:
        fine_idx = sel[fine_idx]
    out[fine_idx] = fine
    return out
