"""Plain model preprocessing: a source cloud to the model points and normals
that pose matching searches, straight from the configuration's semantics.

Radius-PCA normals over the raw cloud, turned away from the model's origin
(a neighbourhood of fewer than three points gives no normal and spoils its
voxel); a centroid per voxel (pcl::VoxelGrid) over positions and normals;
voxels without a finite, non-zero normal dropped; normals made unit;
positions scaled to metres.
"""

from __future__ import annotations

import torch

from .cloud import pca_normals, voxel_centroids


def preprocess(pos, pre, dt=torch.float64, device="cpu"):
    """pos [N, 3] float32 numpy (the source cloud as written), `pre` the
    configuration's "preprocess" block. Returns (pos [M, 3], normal [M, 3])
    in `dt`."""
    p = torch.as_tensor(pos, device=device).to(dt)
    nrm, ok = pca_normals(p, pre["normal_radius"], 3, outward=True)
    nrm = torch.where(ok[:, None], nrm, torch.nan)
    valid = torch.ones(p.shape[0], dtype=torch.bool, device=device)
    vpos, vnrm = voxel_centroids(p, valid, pre["voxel_size"], (nrm,))
    norm = torch.linalg.vector_norm(vnrm.to(torch.float64), dim=1)
    keep = torch.isfinite(vnrm).all(1) & (norm > 1e-12)
    vnrm = vnrm[keep] / norm[keep].to(dt)[:, None]
    return vpos[keep] * pre["model_scale"], vnrm
