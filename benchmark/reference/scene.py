"""Plain scene ingest: an RGB-D frame and its probability maps to the
filtered point cloud that pose matching runs on, straight from the
configuration's semantics.

Back-projection of the depth image through the pinhole camera, and the
reprojection of each kept point, in float32, the precision the
configurations state, in the order the reference's camera model is
evaluated by its compiled programs (x = raw * ((col - cx) * scale) * (1 /
fx); col = trunc((x * fx + cx * z) / z) with one rounding of the
numerator): a voxel of one pixel reprojects exactly onto that pixel's
boundary, so another order would pick the neighbouring pixel there; a centroid
per voxel (pcl::VoxelGrid); radius outlier removal (pcl's radius search,
the point itself counted); the z clip; reprojection to fetch each point's
class probabilities (cut below the threshold) and edge probability; a
point stays while some object's probability is above 0; radius-PCA normals
over the points that stay, turned toward the camera; the first
`max_scene_points` points in voxel order.
"""

from __future__ import annotations

import torch

from .cloud import f32, neighbour_counts, pca_normals, voxel_centroids


def ingest(depth, probs, edge, match, dt=torch.float64, device="cpu"):
    """depth [H, W] uint16, probs [O, H, W] uint16, edge [H, W] uint8 (numpy),
    `match` the configuration's "match" block. Returns a dict of the kept
    points in the camera frame: pos [N, 3], normal [N, 3], prob [O, N],
    edge_prob [N], all in `dt`."""
    cam = match["camera"]
    fx, cx, fy, cy = cam["fx"], cam["cx"], cam["fy"], cam["cy"]
    leaf = match["voxel_size"]
    h, w = depth.shape
    cam_t = torch.float32 if dt == torch.float64 else dt     # the camera model's precision
    raw = torch.as_tensor(depth.astype("int32"), device=device).to(cam_t)
    s = f32(match["depth_scale"])
    z = raw * s
    rows = torch.arange(h, device=device, dtype=cam_t)[:, None]
    cols = torch.arange(w, device=device, dtype=cam_t)[None, :]
    x = (raw * ((cols - f32(cx)) * s)) * f32(1.0 / f32(fx))
    y = (raw * ((rows - f32(cy)) * s)) * f32(1.0 / f32(fy))
    pos = torch.stack(torch.broadcast_tensors(x, y, z), -1).reshape(-1, 3).to(dt)
    pos = voxel_centroids(pos, pos[:, 2] > 0, leaf)[0]

    radius = 2.0 * leaf + match["outlier_radius_bias"]
    valid = neighbour_counts(pos, radius) >= match["outlier_min_neighbors"]
    valid &= (pos[:, 2] > 0) & (pos[:, 2] <= match["max_scene_depth"])
    pc = pos.to(cam_t)
    zc = pc[:, 2]

    def pixel(v, f, c):
        num = (v.double() * f32(f) + (zc * f32(c)).double()).to(cam_t)
        return torch.trunc(num / zc).double()

    col, row = pixel(pc[:, 0], fx, cx), pixel(pc[:, 1], fy, cy)
    valid &= (row >= 0) & (row < h) & (col >= 0) & (col < w)
    r = torch.clamp(row, 0, h - 1).long()
    c = torch.clamp(col, 0, w - 1).long()
    pr = torch.as_tensor(probs.astype("int32"), device=device)[:, r, c].to(dt)
    pr = pr * match["probability_scale"]
    pr = torch.where(pr >= match["class_threshold"], pr, 0.0)
    e = torch.as_tensor(edge.astype("int32"), device=device)[r, c].to(dt)
    edge_prob = (255.0 - e) / 255.0
    valid &= (pr > 0).any(0)

    if match["scene_normal_mode"] != "cloud_pca":
        raise NotImplementedError("the reference computes cloud_pca normals only")
    keep = torch.nonzero(valid).squeeze(1)
    nrm, ok = pca_normals(pos[keep], match["scene_normal_radius_factor"] * leaf, 3,
                          outward=False)
    keep, nrm = keep[ok], nrm[ok]
    cap = match["max_scene_points"]
    keep, nrm = keep[:cap], nrm[:cap]
    return {"pos": pos[keep], "normal": nrm, "prob": pr[:, keep] * 1.0,
            "edge_prob": edge_prob[keep]}
