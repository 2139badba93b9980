"""Plain point-cloud operations for the reference: voxel centroids, radius
neighbour counts, radius-PCA normals and nearest neighbours, by brute force
in blocks of rows. Plain torch; `dt` is the arithmetic's dtype (float64 for
the reference, bfloat16 for its control).
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 512


def f32(c):
    return float(np.float32(c))


def voxel_keys(pos, valid, leaf):
    """pcl::VoxelGrid's binning: floor(p * float32(1 / leaf)) in float32 on
    the absolute lattice, shifted to the valid minimum's cell, clamped into
    1024 cells an axis; one int64 key a point."""
    inv = f32(1.0 / f32(leaf))
    p32 = pos.to(torch.float32)
    k = torch.floor(p32 * inv).to(torch.int64)
    origin = torch.where(valid[:, None], p32, torch.inf).amin(dim=0)
    ijk = torch.clamp(k - torch.floor(origin * inv).to(torch.int64), 0, 1023)
    return (ijk[:, 0] * 1024 + ijk[:, 1]) * 1024 + ijk[:, 2]


def voxel_centroids(pos, valid, leaf, attrs=()):
    """Mean of each voxel's valid members, voxels in ascending key order;
    the same for each of `attrs` ([N, C] each)."""
    key = voxel_keys(pos, valid, leaf)[valid]
    uniq, inv = torch.unique(key, return_inverse=True)
    n = torch.zeros(uniq.numel(), dtype=pos.dtype, device=pos.device)
    n.index_add_(0, inv, torch.ones_like(key, dtype=pos.dtype))
    out = []
    for a in (pos,) + tuple(attrs):
        s = torch.zeros((uniq.numel(), a.shape[1]), dtype=a.dtype, device=a.device)
        s.index_add_(0, inv, a[valid])
        out.append(s / n.to(a.dtype)[:, None])
    return out


def _d2_block(a, b):
    d = a[:, None, :] - b[None, :, :]
    return (d * d).sum(-1)


def neighbour_counts(pos, radius):
    """Points of `pos` within `radius` of each point (itself included)."""
    r2 = radius * radius
    return torch.cat([(_d2_block(pos[i:i + BLOCK], pos) <= r2).sum(1)
                      for i in range(0, pos.shape[0], BLOCK)])


def pca_normals(pos, radius, min_neighbors, outward):
    """Unit normals from the covariance of each point's neighbours within
    `radius`: the eigenvector of the smallest eigenvalue, turned toward the
    origin (the scene's camera) or away from it (`outward`, a model).
    Returns (normal [N, 3], ok [N]: at least `min_neighbors` neighbours)."""
    r2 = radius * radius
    normals, oks = [], []
    for i in range(0, pos.shape[0], BLOCK):
        a = pos[i:i + BLOCK]
        w = (_d2_block(a, pos) <= r2).to(pos.dtype)                 # [b, N]
        cnt = w.sum(1)
        mean = (w[:, :, None] * pos[None]).sum(1) / cnt[:, None]
        d = pos[None] - mean[:, None]                                # [b, N, 3]
        cov = (w[:, :, None, None] * d[..., :, None] * d[..., None, :]).sum(1) / cnt[:, None, None]
        ev = torch.linalg.eigh(cov.to(torch.float64 if pos.dtype == torch.float64
                                      else torch.float32))[1][..., 0].to(pos.dtype)
        dot = (ev * a).sum(-1)
        flip = dot < 0 if outward else dot > 0
        normals.append(torch.where(flip[:, None], -ev, ev))
        oks.append(cnt >= min_neighbors)
    return torch.cat(normals), torch.cat(oks)


def nearest(query, points):
    """(index [Q], squared distance [Q]) of each query's nearest point."""
    idx, d2 = [], []
    for i in range(0, query.shape[0], BLOCK):
        m = _d2_block(query[i:i + BLOCK], points)
        v, j = m.min(1)
        idx.append(j)
        d2.append(v)
    return torch.cat(idx), torch.cat(d2)
