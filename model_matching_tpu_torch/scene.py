"""Scene ingestion: RGB-D images -> filtered, centered point cloud + the
three query structures.

Counterpart of ``model_matching_tpu/scene.py``: back-projection, voxel
centroid downsample, radius outlier removal, z-clip, per-point
probability / colour / normal fetch by reprojection, probability and
normal rejection, compaction to `max_scene_points` lanes, centroid shift
— on the device of the caller's choice — then the neighbour grids and the
dense field built on the same device from the valid lanes, with a few
host reads of their sizes and no transfer of the scene.

The voxel output keeps the input's capacity (one lane per pixel), but its
valid lanes form a prefix (invalid keys sort last). The steps after it run
on that prefix only (`prefix=True`, the default), and the lanes the
compaction would take from beyond it are filled as the padded run fills
them; the result is the same (tests/test_torch_ingest.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .config import MatchConfig
from .io import image as imio
from .ops import geometry, normals as normals_ops, voxel
from .ops.densefield import DenseField, build_dense_field
from .ops.fp import f32, mul_recip, xla_sum0
from .ops.gridhash import NeighborGrid, build_neighbor_grid
from .utils import trace
from .utils.device import require


@dataclasses.dataclass
class ScenePack:
    pos: torch.Tensor          # [P, 3] centered
    normal: torch.Tensor       # [P, 3]
    rgb: torch.Tensor          # [P, 3]
    pixel: torch.Tensor        # [P, 2] (row, col)
    class_prob: torch.Tensor   # [P]
    edge_prob: torch.Tensor    # [P]
    valid: torch.Tensor        # [P] bool
    centroid: torch.Tensor     # [3]
    grid: NeighborGrid         # exact restricted-NN structure (cell = eps)
    field: DenseField          # dense NN field (fast scoring path)
    icp_grid: NeighborGrid     # wider NN structure for ICP correspondences
    edge_free: torch.Tensor    # [H, W] bool
    has_edge: bool = False

    def count(self):
        return self.valid.sum(dtype=torch.int32)

    def to(self, device) -> "ScenePack":
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if f.name != "has_edge"
        }
        return dataclasses.replace(self, **moved)


def _scene_pipeline(rgb, depth_u16, probs_u16, edge_u8, cfg: MatchConfig,
                    prefix: bool = True):
    """rgb [H, W, 3] uint8, depth_u16 [H, W], probs_u16 [O, H, W] (one map
    per object), edge_u8 [H, W] tensors on one device. A point stays valid
    if any object's probability clears the threshold; sub-threshold
    probabilities are zeroed. Returns a dict of [P] lanes (P =
    min(max_scene_points, H*W)), valid lanes first, plus `count` and
    `truncated` (valid points dropped by the cap) as tensors."""
    fx, cx, fy, cy = cfg.camera.as_tuple()
    h, w = depth_u16.shape
    n_pix = h * w
    depth_f = depth_u16.to(torch.float32)
    pos = geometry.backproject_depth(depth_f, fx, cx, fy, cy,
                                     depth_scale=cfg.depth_scale).reshape(-1, 3)
    valid = pos[:, 2] > 0

    # voxel centroid downsample (pcl::VoxelGrid)
    pos, valid, _ = voxel.voxel_downsample_centroid(pos, valid, cfg.voxel_size)
    if prefix:
        trace.count("host_reads")
        m = int(valid.sum())                         # host read
        pos, valid = pos[:m], valid[:m]

    # radius outlier removal, z-clip
    valid = valid & voxel.radius_outlier_mask(
        pos, valid, 2.0 * cfg.voxel_size + cfg.outlier_radius_bias,
        cfg.outlier_min_neighbors)
    valid = valid & (pos[:, 2] > 0) & (pos[:, 2] <= f32(cfg.max_scene_depth))

    # reproject centroids to fetch per-pixel attributes
    pix = geometry.project_points(pos, fx, cx, fy, cy)
    row = torch.clamp(pix[:, 0], 0, h - 1).long()
    col = torch.clamp(pix[:, 1], 0, w - 1).long()
    valid = valid & (pix[:, 0] >= 0) & (pix[:, 0] < h) & (pix[:, 1] >= 0) & (pix[:, 1] < w)

    class_prob = probs_u16[:, row, col].to(torch.float32) * f32(cfg.probability_scale)
    class_prob = torch.where(class_prob >= f32(cfg.class_threshold), class_prob, 0.0)
    edge_prob = mul_recip(255.0 - edge_u8[row, col].to(torch.float32), 255.0)
    rgbv = rgb[row, col].to(torch.float32)
    valid = valid & (class_prob > 0).any(dim=0)

    if cfg.scene_normal_mode == "depth":
        nrm_img, nrm_ok = normals_ops.depth_normals(depth_f, fx, cx, fy, cy, window=5)
        nrm = nrm_img[row, col]
        valid = valid & nrm_ok[row, col] & (nrm != 0.0).any(dim=-1)
    else:
        nrm, nok = normals_ops.grid_pca_normals(
            pos, valid, cfg.scene_normal_radius_factor * cfg.voxel_size)
        valid = valid & nok

    # compact valid lanes to the front (stable), cap at max_scene_points
    cap = min(cfg.max_scene_points, n_pix)
    lanes = pos.shape[0]
    valid_total = valid.sum(dtype=torch.int32)
    take = torch.sort((~valid).to(torch.int8), stable=True).indices[:cap]
    pixel = torch.stack([row, col], dim=-1).to(torch.int32)[take]
    pos, valid, nrm = pos[take], valid[take], nrm[take]
    class_prob, edge_prob, rgbv = class_prob[:, take], edge_prob[take], rgbv[take]
    if lanes < cap:
        # lanes past the voxel prefix: position 0, projected to pixel (0, 0)
        pad = cap - lanes
        pos = torch.cat([pos, pos.new_zeros((pad, 3))])
        valid = torch.cat([valid, valid.new_zeros(pad)])
        nrm = torch.cat([nrm, nrm.new_zeros((pad, 3))])
        pixel = torch.cat([pixel, pixel.new_zeros((pad, 2))])
        class_prob = torch.cat([class_prob, class_prob.new_zeros((class_prob.shape[0], pad))], 1)
        edge_prob = torch.cat([edge_prob, edge_prob.new_zeros(pad)])
        rgbv = torch.cat([rgbv, rgb[0, 0].to(torch.float32).expand(pad, 3)])
    class_prob = torch.where(valid[None, :], class_prob, 0.0)
    edge_prob = torch.where(valid, edge_prob, 0.0)

    # centroid shift: the float32 sum in XLA's order over the padded lanes
    # of the JAX package (max_scene_points rows), divided by the count
    kept = valid.sum(dtype=torch.int32)
    cnt = torch.clamp(kept.to(torch.float64), min=1.0)
    centroid = (xla_sum0(torch.where(valid[:, None], pos, 0.0)).double()
                / cnt).to(torch.float32)
    pos = torch.where(valid[:, None], pos - centroid, 0.0)
    return dict(
        pos=pos, normal=torch.where(valid[:, None], nrm, 0.0), rgb=rgbv,
        pixel=pixel, class_prob=class_prob, edge_prob=edge_prob, valid=valid,
        centroid=centroid, count=kept, truncated=valid_total - kept,
    )


def _read_images(rgb_path, depth_path, class_prob_paths, edge_path):
    rgb = imio.read_rgb(rgb_path)
    depth = imio.read_u16(depth_path)
    probs = np.stack([imio.read_u16(p) for p in class_prob_paths])
    has_edge = edge_path is not None and os.path.exists(edge_path)
    edge = imio.read_u8(edge_path) if has_edge else np.zeros(depth.shape, np.uint8)
    return rgb, depth, probs, edge, has_edge


def load_scene(
    rgb_path: str,
    depth_path: str,
    class_prob_path: str,
    edge_path: Optional[str],
    cfg: MatchConfig,
    device="cuda",
) -> ScenePack:
    """Image reads + the ingest pipeline and the structure builds on
    `device`. A missing edge map reads as zeros (all free space); a present
    one marks the scene `has_edge` (the instance path)."""
    pack, _probs = load_scene_multi(
        rgb_path, depth_path, [class_prob_path], edge_path, cfg, device=device)
    return pack


def load_scene_multi(
    rgb_path: str,
    depth_path: str,
    class_prob_paths,
    edge_path: Optional[str],
    cfg: MatchConfig,
    device="cuda",
):
    """One shared scene geometry (union of the per-object probability
    supports), per-object probability vectors. Returns (ScenePack, probs
    [O, P]); the pack's class_prob holds object 0's vector. Spans:
    `scene.load`, with `scene.read` (the PNG decode), `scene.pipeline` (the
    uploads, the device pipeline and the read of its point count) and
    `scene.build` (the grids and the field; counts the bytes its host reads
    move as `scene.build_copy_bytes`)."""
    dev = require(device)
    with trace.span("scene.load"):
        with trace.span("scene.read"):
            rgb, depth, probs, edge, has_edge = _read_images(
                rgb_path, depth_path, class_prob_paths, edge_path)
        with trace.span("scene.pipeline"):
            edge_t = torch.from_numpy(edge).to(dev)
            out = _scene_pipeline(
                torch.from_numpy(rgb).to(dev),
                torch.from_numpy(depth.astype(np.int32)).to(dev),
                torch.from_numpy(probs.astype(np.int32)).to(dev),
                edge_t, cfg,
            )
            from .estimator import _to_host

            count, truncated = (int(v) for v in _to_host(out["count"], out["truncated"]))
        with trace.span("scene.build"):
            read0 = trace.total("host_read_bytes")
            pack = _build_structures(out, count, truncated, edge_t, has_edge,
                                     len(class_prob_paths) == 1, cfg)
            trace.count("scene.build_copy_bytes", trace.total("host_read_bytes") - read0)
        return pack, out["class_prob"]


def _build_structures(out, count, truncated, edge_t, has_edge, single, cfg: MatchConfig):
    """Both neighbour grids and the dense field, built on the device of the
    ingested lanes from their valid prefix (`count` lanes), assembled into
    the ScenePack. Object 0's probabilities are baked into the scoring
    structures only when that is unambiguous (`single`: one probability
    map)."""
    if truncated > 0:
        from .utils.log import warn

        warn(
            f"scene capacity max_scene_points dropped {truncated} valid "
            f"points — raise MatchConfig.max_scene_points",
            dropped=truncated, cap=cfg.max_scene_points,
        )
    pos, nrm = out["pos"][:count], out["normal"][:count]
    prob = out["class_prob"][0, :count] if single else None
    return ScenePack(
        pos=out["pos"], normal=out["normal"], rgb=out["rgb"],
        pixel=out["pixel"], class_prob=out["class_prob"][0],
        edge_prob=out["edge_prob"], valid=out["valid"], centroid=out["centroid"],
        grid=build_neighbor_grid(pos, cell_size=cfg.distance_threshold, normal=nrm, prob=prob),
        field=build_dense_field(pos, nrm, cfg.distance_threshold, prob=prob),
        icp_grid=build_neighbor_grid(pos, cell_size=cfg.icp_max_corr_dist),
        edge_free=edge_t == 255, has_edge=has_edge,
    )
