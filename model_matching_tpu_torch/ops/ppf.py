"""Point-pair-feature (PPF) computation and integer binning, in torch.

Counterpart of ``model_matching_tpu/ops/ppf.py``. The feature of a pair is

    u  = p1 - p2
    f1 = int(|u| * 1000)                       # mm, truncated
    f2 = int(atan2(|n1 x u|, n1.u) * 180/pi)   # degrees in [0, 180]
    f3 = int(atan2(|n2 x u|, n2.u) * 180/pi)
    f4 = int(atan2(|n1 x n2|, n1.n2) * 180/pi)

each snapped to the closest multiple of its discretization. Every function
broadcasts over leading dims and keeps the device of its inputs.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import fmath
from .fp import sqrt_rn

RAD2DEG = 180.0 / math.pi

# Distance bins at or below this many mm are never stored in the PPF map.
MIN_DISTANCE_BIN_MM = 5

# Key packing: 4 bin indices packed into one int32 as base-64 digits for the
# three angles (index < 64 for any rot discretization >= 4).
_ANGLE_RADIX = 64


def _dot3(a, b):
    # the trailing + 0.0 turns a -0.0 sum into +0.0, as a reduction that
    # starts from +0.0 gives it: the sign decides atan2(0, +-0)
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2] + 0.0


def _cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def ppf_features(p1, n1, p2, n2):
    """Raw truncated-integer features, [..., 4] int32."""
    p1, n1, p2, n2 = torch.broadcast_tensors(p1, n1, p2, n2)
    u = p1 - p2
    d = sqrt_rn(_dot3(u, u))

    # the three angles (n1, u), (n2, u), (n1, n2) through one atan2
    a = torch.stack([n1, n2, n1], dim=-2)
    b = torch.stack([u, u, n2], dim=-2)
    c = _cross(a, b)
    deg = fmath.atan2(sqrt_rn(_dot3(c, c)), _dot3(a, b)) * RAD2DEG   # [..., 3]
    f1 = (d * 1000.0).to(torch.int32)
    return torch.cat([f1[..., None], deg.to(torch.int32)], dim=-1)


def ppf_closest_bin(value, disc):
    """Snap non-negative ints to the closest multiple of disc; ties round up."""
    lower = value - value % disc
    upper = lower + disc
    return torch.where(value - lower < upper - value, lower, upper)


def ppf_bins(p1, n1, p2, n2, tr_disc: int, rot_disc: int):
    """Binned PPF, [..., 4] int32."""
    f = ppf_features(p1, n1, p2, n2)
    b1 = ppf_closest_bin(f[..., 0], tr_disc)
    brot = ppf_closest_bin(f[..., 1:], rot_disc)
    return torch.cat([b1[..., None], brot], dim=-1)


def pack_key(bins, tr_disc: int, rot_disc: int):
    """Pack a binned PPF [..., 4] into one int32 key; -1 when the bin could
    never exist in the map (distance <= 5 mm or a negative angle)."""
    q1 = torch.div(bins[..., 0], tr_disc, rounding_mode="floor")
    q2 = torch.div(bins[..., 1], rot_disc, rounding_mode="floor")
    q3 = torch.div(bins[..., 2], rot_disc, rounding_mode="floor")
    q4 = torch.div(bins[..., 3], rot_disc, rounding_mode="floor")
    key = ((q1 * _ANGLE_RADIX + q2) * _ANGLE_RADIX + q3) * _ANGLE_RADIX + q4
    invalid = (
        (bins[..., 0] <= MIN_DISTANCE_BIN_MM)
        | (bins[..., 1] < 0)
        | (bins[..., 2] < 0)
        | (bins[..., 3] < 0)
    )
    return torch.where(invalid, -1, key).to(torch.int32)


def ppf_keys(p1, n1, p2, n2, tr_disc: int, rot_disc: int):
    """Packed int32 key of the pair PPF."""
    return pack_key(ppf_bins(p1, n1, p2, n2, tr_disc, rot_disc), tr_disc, rot_disc)


def _angle_bin_cos_thresholds(rot_disc: int) -> np.ndarray:
    """Cosines of the integer angles disc*j - disc//2 at which the snapped
    angle bin increments (see angle_bin_index)."""
    lo = rot_disc // 2
    bounds = np.arange(1, 180 // rot_disc + 2) * rot_disc - lo
    bounds = bounds[bounds <= 180]
    return np.cos(np.radians(bounds.astype(np.float64))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _angle_bin_thresholds(rot_disc: int, device: str) -> torch.Tensor:
    """The thresholds as a tensor, made once per device: an upload on
    every call would stall the launch queue, and cannot be captured in a
    CUDA graph."""
    return torch.from_numpy(_angle_bin_cos_thresholds(rot_disc)).to(device)


def angle_bin_index(cos_angle, rot_disc: int):
    """Bin index m (bin value = m * rot_disc) of an atan2-style angle in
    [0, 180] from its cosine: the count of boundary cosines it lies at or
    below (the angle decreases monotonically in its cosine)."""
    th = _angle_bin_thresholds(rot_disc, str(cos_angle.device))
    return (cos_angle[..., None] <= th).sum(dim=-1, dtype=torch.int32)


def ppf_keys_fast(p1, n1, p2, n2, tr_disc: int, rot_disc: int):
    """Transcendental-free packed PPF keys (normals must be unit length)."""
    u = p1 - p2
    d = sqrt_rn(_dot3(u, u))
    inv_d = torch.where(d > 0, 1.0 / torch.clamp(d, min=1e-30), 0.0)

    def cosang(n):
        return torch.clamp(_dot3(n, u) * inv_d, -1.0, 1.0)

    c1 = cosang(n1)
    c2 = cosang(n2)
    c3 = torch.clamp(_dot3(n1, n2), -1.0, 1.0)

    v = (d * 1000.0).to(torch.int32)
    q1 = torch.div(v + tr_disc // 2, tr_disc, rounding_mode="floor")
    a1 = angle_bin_index(c1, rot_disc)
    a2 = angle_bin_index(c2, rot_disc)
    a3 = angle_bin_index(c3, rot_disc)
    key = ((q1 * _ANGLE_RADIX + a1) * _ANGLE_RADIX + a2) * _ANGLE_RADIX + a3
    invalid = (q1 * tr_disc) <= MIN_DISTANCE_BIN_MM
    return torch.where(invalid, -1, key).to(torch.int32)


def fanout_deltas(tr_disc: int, rot_disc: int) -> np.ndarray:
    """The 2x4x4x4 = 128 insertion fan-out offsets, [128, 4] int32 in
    bin-index units: p1 in {f1-tr, f1}, each angle in {f-2r, f-r, f, f+r}."""
    d1 = np.array([-1, 0], dtype=np.int32)
    dr = np.array([-2, -1, 0, 1], dtype=np.int32)
    return np.stack(
        np.meshgrid(d1, dr, dr, dr, indexing="ij"), axis=-1
    ).reshape(-1, 4)


def inverse_fanout_deltas(tr_disc: int, rot_disc: int) -> np.ndarray:
    """Offsets from a query bin to its candidate source bins (query =
    source + delta, so source = query - delta), [128, 4] int32."""
    return -fanout_deltas(tr_disc, rot_disc)
