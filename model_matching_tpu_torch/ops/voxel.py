"""Voxel downsampling and radius outlier removal as sort/segment ops.

Counterpart of ``model_matching_tpu/ops/voxel.py`` (pcl::VoxelGrid's
centroid per voxel, the first-point-per-voxel sampler, and
pcl::RadiusOutlierRemoval). Inputs are padded [N, ...] arrays plus
validity masks; outputs keep the input capacity.

Arithmetic follows the JAX package's compiled programs, so that the two
packages give the same bits and the card gives the CPU's bits:

* binning is floor(p * float32(1/leaf)) on the absolute lattice;
* a segment sum adds the voxel's members one at a time in sorted order,
  in float32, as XLA's scatter-add does: each step adds one member to
  every voxel at once (no atomics, so the order is fixed on every device);
* a squared distance is the fused chain of ``ops/fp.dot3``.

The neighbour searches take each of the 27 neighbour cells as one
[N, width] block, `width` being the longest voxel run (at most
`cell_cap`), instead of `cell_cap` sequential steps.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..utils import trace
from .fp import dot3, f32, mul_recip

# Cells per axis for linearized voxel keys; indices are anchored at the
# cloud minimum and clamped into [0, 1023].
_GRID_AXIS = 1024
_INVALID_KEY = 2**31 - 1
_BIG = 3.0e38

OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def _voxel_ijk(pos, origin, leaf):
    # pcl::VoxelGrid binning: floor(p * (1/leaf)) with the reciprocal
    # rounded to float32 first, on the absolute lattice; the origin shift
    # is done on the integer indices. Depths stored as u16 sit exactly on
    # leaf boundaries, so any other evaluation order moves points between
    # voxels.
    inv = f32(1.0 / f32(leaf))
    k = torch.floor(pos * inv).to(torch.int32)
    k0 = torch.floor(origin * inv).to(torch.int32)
    return torch.clamp(k - k0, 0, _GRID_AXIS - 1)


def _linear_key(ijk):
    ijk = ijk.to(torch.int64)
    return (ijk[..., 0] * _GRID_AXIS + ijk[..., 1]) * _GRID_AXIS + ijk[..., 2]


def _masked_origin(pos, valid):
    return torch.where(valid[:, None], pos, _BIG).amin(dim=0)


def _sorted_keys(pos, valid, cell):
    """(key [N] int64, sorted keys, sort order): voxel keys of `cell`-sized
    cells anchored at the valid minimum, invalid lanes keyed last."""
    ijk = _voxel_ijk(pos, _masked_origin(pos, valid), cell)
    key = torch.where(valid, _linear_key(ijk), _INVALID_KEY)
    key_s, order = torch.sort(key, stable=True)
    return key, key_s, order


def _longest_run(key_s, cap: int) -> int:
    """The longest run of one valid key in the sorted keys, capped (one
    host read)."""
    _u, counts = torch.unique_consecutive(key_s, return_counts=True)
    counts = torch.where(_u == _INVALID_KEY, 0, counts)
    if not counts.numel():
        return 1
    trace.count("host_reads")
    return max(1, min(cap, int(counts.max())))


def neighbor_blocks(pos, key, key_s, pos_s, cap: int, width: int):
    """Yield, for each of the 27 neighbour cells in the JAX package's
    order, (members [N, width, 3], in_cell [N, width] bool): the first
    `width` members of the cell's run in the sorted cloud (the run capped at
    `cap`)."""
    n = pos.shape[0]
    k = torch.arange(width, device=pos.device)
    for dx, dy, dz in OFFSETS:
        nkey = key + (dx * _GRID_AXIS + dy) * _GRID_AXIS + dz
        start = torch.searchsorted(key_s, nkey, side="left")
        end = torch.searchsorted(key_s, nkey, side="right")
        span = torch.clamp(end - start, max=cap)
        idx = torch.clamp(start[:, None] + k, max=n - 1)
        yield pos_s[idx], k < span[:, None]


def _sequential_segment_sums(x_s, seg, n_seg: int, width: int):
    """Per-segment float32 sums of the rows of x_s [N, C] (grouped by
    segment, segments numbered from 0 in order), member after member in
    order from 0.0, as XLA's scatter-add accumulates; rows of segments >=
    n_seg are ignored. Returns [n_seg, C]."""
    n, c = x_s.shape
    dev = x_s.device
    lane = torch.arange(n, device=dev)
    is_new = torch.ones(n, dtype=torch.bool, device=dev)
    is_new[1:] = seg[1:] != seg[:-1]
    rank = lane - torch.cummax(torch.where(is_new, lane, 0), 0).values
    keep = seg < n_seg
    dense = torch.zeros((n_seg, width, c), dtype=x_s.dtype, device=dev)
    dense[seg[keep], rank[keep]] = x_s[keep]
    acc = torch.zeros((n_seg, c), dtype=x_s.dtype, device=dev)
    for j in range(width):
        acc = acc + dense[:, j]
    return acc


def voxel_downsample_centroid(
    pos: torch.Tensor,
    valid: torch.Tensor,
    leaf: float,
    attrs: Dict[str, torch.Tensor] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Centroid-per-voxel downsampling (every field averaged over the
    voxel's members). Returns (pos, valid, attrs) padded to the input
    capacity; output order is ascending voxel key, so the valid lanes are a
    prefix."""
    attrs = attrs or {}
    n = pos.shape[0]
    dev = pos.device
    key, key_s, order = _sorted_keys(pos, valid, leaf)
    is_new = torch.ones(n, dtype=torch.bool, device=dev)
    is_new[1:] = key_s[1:] != key_s[:-1]
    seg = torch.cumsum(is_new.to(torch.int64), 0) - 1
    trace.count("host_reads")
    n_seg_valid = int((is_new & (key_s != _INVALID_KEY)).sum())   # host read
    cols = [pos] + [v.to(pos.dtype).reshape(n, -1) for v in attrs.values()]
    x_s = torch.cat(cols, dim=1)[order]
    width = _longest_run(key_s, n)
    sums = _sequential_segment_sums(x_s, seg, n_seg_valid, width)
    counts = torch.zeros(n_seg_valid, dtype=torch.int64, device=dev)
    counts.index_add_(0, seg[seg < n_seg_valid],
                      torch.ones_like(seg[seg < n_seg_valid]))
    means = sums / counts.to(pos.dtype)[:, None]
    out = torch.zeros((n, x_s.shape[1]), dtype=pos.dtype, device=dev)
    out[:n_seg_valid] = means
    out_valid = torch.arange(n, device=dev) < n_seg_valid
    out_attrs, c0 = {}, 3
    for name, v in attrs.items():
        w = v.reshape(n, -1).shape[1]
        out_attrs[name] = out[:, c0:c0 + w].reshape((n,) + tuple(v.shape[1:]))
        c0 += w
    return out[:, :3].contiguous(), out_valid, out_attrs


def voxel_downsample_first(pos: torch.Tensor, valid: torch.Tensor, leaf: float):
    """First-point-per-voxel selection mask over the *input* order (voxels
    are floor(p / leaf) on the absolute lattice; ties keep input order)."""
    ijk = torch.floor(mul_recip(pos, leaf)).to(torch.int32)
    ijk = torch.clamp(ijk + _GRID_AXIS // 2, 0, _GRID_AXIS - 1)
    key = torch.where(valid, _linear_key(ijk), _INVALID_KEY)
    key_s, order = torch.sort(key, stable=True)
    is_first = torch.ones_like(valid)
    is_first[1:] = key_s[1:] != key_s[:-1]
    keep_sorted = is_first & (key_s != _INVALID_KEY)
    keep = torch.zeros_like(valid)
    keep[order] = keep_sorted
    return keep


def radius_outlier_mask(
    pos: torch.Tensor,
    valid: torch.Tensor,
    radius: float,
    min_neighbors: int,
    cell_cap: int = 64,
) -> torch.Tensor:
    """Keep-mask for points with >= min_neighbors within `radius` (self
    included, like pcl::RadiusOutlierRemoval's radiusSearch): a sorted
    voxel grid of cell = radius and a 27-cell count capped at `cell_cap`
    members per cell."""
    key, key_s, order = _sorted_keys(pos, valid, radius)
    pos_s = pos[order]
    r2 = f32(radius * radius)
    width = _longest_run(key_s, cell_cap)
    counts = torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device)
    for members, in_cell in neighbor_blocks(pos, key, key_s, pos_s, cell_cap, width):
        diff = pos[:, None, :] - members
        hit = in_cell & (dot3(diff, diff) <= r2)
        counts += hit.sum(dim=1, dtype=torch.int32)
    return valid & (counts >= min_neighbors)
