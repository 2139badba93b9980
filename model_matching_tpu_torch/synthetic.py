"""A self-contained synthetic model/scene pair, made from a seed.

`synthetic_setup` mirrors the JAX package's
``__graft_entry__._synthetic_setup``: the same numpy draws from the same
seed give the same arrays — a half-ellipsoid shell model posed in the
scene over a flat clutter plane, class probability 0.9 on the object and
0.12 on the clutter — built with the port's host builders. Unlike the JAX
helper, the model pack carries its endpoint-row table (``pair_ep``), as a
model loaded from disk does, so the dense congruent tiers run their
blocked layout.

`write_synthetic_scene` renders the same shell at the same pose into an
RGB-D frame and writes it, with a dense source cloud of the object, in the
files the command-line tools read. `write_synthetic_multi_scene` renders
three distinct shells (`MULTI_SHELLS`) into one frame through a z-buffer
and writes each object's files, probability map and ground truth.
`write_synthetic_packed_scene` renders copies of one flat-faced box
(`PACKED_BOX`) side by side on a bin floor through the `packed` preset's
camera, with an edge map along the box boundaries: the bin-of-boxes
instance scene whose coplanar PPF bins fill the preset's top congruent
tier. `write_synthetic_scene(preset="linemod")` writes its source cloud in
millimetres, as LINEMOD's models are.

Both have an edge-mapped variant (`edge=True`) that sends the estimator
down the instance path: in memory the points are laid on an image grid
with an edge wall between object and clutter (`synthetic_edge_arrays`); on
disk the scene gains `probability_maps/edge.png` (`synthetic_edge_map`).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .config import CameraIntrinsics, MatchConfig, get_preset
from .io import image, ply
from .model import ModelPack, build_pair_ep
from .ops.densefield import build_dense_field
from .ops.gridhash import build_neighbor_grid
from .ppf_table import build_ppf_table
from .scene import ScenePack
from .utils.device import require


# the half-ellipsoid shell (semi-axes, metres)
_AXES = (0.08, 0.065, 0.05)


# the shells of write_synthetic_multi_scene: name, semi-axes, and the pose
# (a turn about the camera's z axis in radians, a translation in metres);
# the first is the shell and pose of synthetic_arrays
MULTI_SHELLS = (
    ("shell_a", _AXES, 0.7, (0.05, -0.1, 0.8)),
    ("shell_b", (0.05, 0.09, 0.04), -0.4, (-0.12, 0.06, 0.82)),
    ("shell_c", (0.065, 0.045, 0.035), 1.9, (0.13, 0.06, 0.78)),
)


def _shell(rng, n, axes):
    """n points of the half-ellipsoid shell with semi-axes `axes` (z <= 0)
    and their outward normals, float32."""
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(np.pi / 2, np.pi, n)
    a, b, c = axes
    pos = np.stack(
        [a * np.sin(v) * np.cos(u), b * np.sin(v) * np.sin(u), c * np.cos(v)],
        axis=1,
    ).astype(np.float32)
    nrm = np.stack(
        [np.sin(v) * np.cos(u) / a, np.sin(v) * np.sin(u) / b, np.cos(v) / c],
        axis=1,
    ).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pos, nrm


# the box of write_synthetic_packed_scene: edge lengths in metres (a soap
# bar's carton) and its copies' grid on the bin floor (columns, rows, gap)
PACKED_BOX = (0.095, 0.062, 0.032)
PACKED_GRID = (4, 2, 0.012)


def _box(rng, n, dims):
    """n points on the surface of a box with edge lengths `dims` centred at
    the origin (each face drawn in proportion to its area) and their
    outward face normals, float32."""
    half = np.asarray(dims, np.float64) / 2.0
    faces = [(ax, sgn) for ax in range(3) for sgn in (-1.0, 1.0)]
    area = np.array([np.prod(np.delete(dims, ax)) for ax, _s in faces])
    face = rng.choice(len(faces), size=n, p=area / area.sum())
    pos = rng.uniform(-1.0, 1.0, (n, 3)) * half
    nrm = np.zeros((n, 3))
    for f, (ax, sgn) in enumerate(faces):
        on = face == f
        pos[on, ax] = sgn * half[ax]
        nrm[on, ax] = sgn
    return pos.astype(np.float32), nrm.astype(np.float32)


def _pose(th, t):
    """4x4 float32: a turn of `th` radians about z, then translation t."""
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3] = np.array(
        [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
        np.float32,
    )
    gt[:3, 3] = t
    return gt


def synthetic_arrays(num_model=320, num_scene=1024, seed=0):
    """(model pos, model normal, scene pos, scene normal, scene prob,
    ground-truth 4x4 pose) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    mpos, mnrm = _shell(rng, num_model, _AXES)
    _name, _axes, th, t = MULTI_SHELLS[0]
    gt = _pose(th, t)

    sobj = mpos @ gt[:3, :3].T + gt[:3, 3]
    snrm_obj = mnrm @ gt[:3, :3].T
    ncl = num_scene - num_model
    clutter = np.stack(
        [rng.uniform(-0.3, 0.3, ncl), rng.uniform(-0.3, 0.3, ncl),
         np.full(ncl, 0.9) + rng.normal(0, 0.002, ncl)],
        axis=1,
    ).astype(np.float32)
    cl_nrm = np.tile(np.array([0, 0, -1.0], np.float32), (ncl, 1))
    spos = np.concatenate([sobj, clutter])
    snrm = np.concatenate([snrm_obj, cl_nrm])
    sprob = np.concatenate(
        [np.full(num_model, 0.9, np.float32), np.full(ncl, 0.12, np.float32)]
    )
    return mpos, mnrm, spos, snrm, sprob, gt


def synthetic_edge_arrays(num_model, num_scene, seed=0, height=64, width=64):
    """An image layout for the points of `synthetic_arrays`, made from
    `seed`: (pixel [num_scene, 2] int32 (row, col), edge_prob [num_scene]
    float32, edge_free [height, width] bool). Object points take distinct
    pixels above row height // 2, clutter points distinct pixels below it,
    and that row is an edge wall across the whole image, so a segment grown
    from an object point never reaches the clutter. The last four clutter
    points sit on the wall itself (edge probability 1: never sampled)."""
    rng = np.random.default_rng(seed)
    wall = height // 2
    ncl = num_scene - num_model
    n_wall = min(4, ncl)
    top, bottom = (wall - 1) * width, (height - wall - 1) * width
    if num_model > top or ncl - n_wall > bottom:
        raise ValueError(
            f"{num_model} object and {ncl} clutter points do not fit a "
            f"{height}x{width} image: pass a larger one")
    pixel = np.zeros((num_scene, 2), np.int32)
    flat = rng.choice(top, size=num_model, replace=False)
    pixel[:num_model] = np.stack([flat // width, flat % width], axis=-1)
    flat = rng.choice(bottom, size=ncl - n_wall, replace=False)
    pixel[num_model:num_scene - n_wall] = np.stack(
        [wall + 1 + flat // width, flat % width], axis=-1)
    pixel[num_scene - n_wall:] = np.stack(
        [np.full(n_wall, wall), rng.choice(width, size=n_wall, replace=False)], axis=-1)
    edge_prob = np.zeros(num_scene, np.float32)
    edge_prob[num_scene - n_wall:] = 1.0
    edge_free = np.ones((height, width), bool)
    edge_free[wall, :] = False
    return pixel, edge_prob, edge_free


# cell distributions that can break a scan of the dense gate that buckets
# its columns by a hash of the cell id (ops/dense_gate.py)
GATE_CELL_CASES = ("one_cell", "all_distinct", "above_low_6_bits",
                   "above_low_16_bits")


def gate_cells(kind: str, rng: np.random.Generator, n: int) -> np.ndarray:
    """[n] int32 cell ids in [0, 2^30) of one of GATE_CELL_CASES: the same
    cell on every lane; every lane a cell of its own (a permutation of
    0..n-1); ids that differ only above their low 6 bits; ids that differ
    only above their low 16 bits (so any hash of low bits collides)."""
    if kind == "one_cell":
        c = np.full(n, 5)
    elif kind == "all_distinct":
        c = rng.permutation(n)
    elif kind == "above_low_6_bits":
        c = (rng.integers(0, 12, n) << 6) | 0x2A
    elif kind == "above_low_16_bits":
        c = (rng.integers(0, 12, n) << 16) | 0x1234
    else:
        raise ValueError(f"unknown cell distribution {kind!r}")
    return c.astype(np.int32)


def synthetic_setup(num_model=320, num_scene=1024, num_bases=16,
                    max_pairs=512, max_congruent=32, seed=0, device="cuda",
                    edge=False):
    """(ModelPack, ScenePack, MatchConfig) with the packs on `device` (the
    card unless the caller asks for the CPU). `edge=True` gives the scene
    the image layout and edge wall of `synthetic_edge_arrays` and marks it
    `has_edge`: the instance path."""
    device = require(device)
    mpos, mnrm, spos, snrm, sprob, _gt = synthetic_arrays(
        num_model, num_scene, seed
    )
    cfg = MatchConfig(
        number_of_bases=num_bases,
        max_scene_points=num_scene,
        max_model_points=num_model,
        max_pairs_per_bin=max_pairs,
        maximum_congruent_sets=max_congruent,
    )
    table, _ = build_ppf_table(
        mpos, mnrm, cfg.ppf_tr_discretization, cfg.ppf_rot_discretization
    )
    mc = mpos.mean(0)
    mpos_c = torch.from_numpy(mpos - mc)
    model = ModelPack(
        pos=mpos_c, normal=torch.from_numpy(mnrm),
        rgb=torch.zeros(num_model, 3), valid=torch.ones(num_model, dtype=torch.bool),
        centroid=torch.from_numpy(mc), table=table,
        pair_ep=build_pair_ep(mpos_c, table.pairs),
    )
    sc = spos.mean(0)
    centered = spos - sc
    if edge:
        pixel, edge_prob, edge_free = (
            torch.from_numpy(a) for a in synthetic_edge_arrays(num_model, num_scene, seed))
    else:
        pixel = torch.zeros(num_scene, 2, dtype=torch.int32)
        edge_prob = torch.zeros(num_scene)
        edge_free = torch.ones(16, 16, dtype=torch.bool)
    scene = ScenePack(
        pos=torch.from_numpy(centered), normal=torch.from_numpy(snrm),
        rgb=torch.zeros(num_scene, 3),
        pixel=pixel,
        class_prob=torch.from_numpy(sprob),
        edge_prob=edge_prob,
        valid=torch.ones(num_scene, dtype=torch.bool),
        centroid=torch.from_numpy(sc),
        grid=build_neighbor_grid(
            centered, cell_size=cfg.distance_threshold, normal=snrm, prob=sprob
        ),
        field=build_dense_field(centered, snrm, cfg.distance_threshold, prob=sprob),
        icp_grid=build_neighbor_grid(centered, cell_size=cfg.icp_max_corr_dist),
        edge_free=edge_free,
        has_edge=edge,
    )
    return model.to(device), scene.to(device), cfg


def _ray_depth(d, axes, gt):
    """Depth of the first hit of the rays s * d (d [H, W, 3] with d_z = 1)
    on the visible half of the shell `axes` posed by `gt` (float64), and
    the hit mask."""
    rot, t = gt[:3, :3], gt[:3, 3]
    o_m = -rot.T @ t
    d_m = d @ rot                                     # (R^T d) per pixel
    inv2 = 1.0 / np.square(np.asarray(axes))
    qa = (d_m * d_m * inv2).sum(-1)
    qb = 2.0 * (d_m * o_m * inv2).sum(-1)
    qc = (o_m * o_m * inv2).sum() - 1.0
    disc = qb * qb - 4 * qa * qc
    s = (-qb - np.sqrt(np.maximum(disc, 0.0))) / (2 * qa)
    z_model = o_m[2] + s * d_m[..., 2]
    return s, (disc > 0) & (s > 0) & (z_model <= 0)


def _box_depth(d, dims, gt):
    """Depth of the first hit of the rays s * d (d [H, W, 3] with d_z = 1)
    on the box `dims` posed by `gt` (float64; slab test in the box frame),
    and the hit mask."""
    rot, t = gt[:3, :3], gt[:3, 3]
    o_b = -rot.T @ t
    d_b = d @ rot
    half = np.asarray(dims) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-half - o_b) / d_b
        t2 = (half - o_b) / d_b
    near = np.nan_to_num(np.minimum(t1, t2), nan=-np.inf).max(-1)
    far = np.nan_to_num(np.maximum(t1, t2), nan=np.inf).min(-1)
    return near, (far >= near) & (near > 0)


def _camera_rays(camera, width, height):
    fx, cx, fy, cy = camera
    rows, cols = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    return np.stack([(cols - cx) / fx, (rows - cy) / fy, np.ones_like(cols, float)], -1)


# the plane of synthetic_rgbd: a 0.55 x 0.42 m table top 0.9025 m from
# the camera, facing it (x and y bounds in metres, camera frame)
_PLANE_Z, _PLANE_X, _PLANE_Y = 0.9025, (-0.27, 0.28), (-0.21, 0.21)


def synthetic_rgbd(camera, width=640, height=480, depth_scale=1e-4,
                   probability_scale=1e-4, seed=0):
    """Render the shell at its ground-truth pose over a plane 0.9025 m from
    the camera, through a pinhole `camera` (fx, cx, fy, cy).

    Returns (rgb [H, W, 3] uint8, depth [H, W] uint16, probability
    [H, W] uint16, gt 4x4 model->camera pose): depth carries seeded
    Gaussian noise of 0.5 mm, class probability is 0.9 on the object and
    0.12 on the plane. The plane is a table top of fixed extent
    (`_PLANE_X`, `_PLANE_Y`); pixels beyond it have no depth. The ycb
    camera's 640x480 view lies inside it, and there the preset keeps about
    10,000 scene points, under its 16,384-point cap."""
    rng = np.random.default_rng(seed)
    gt = synthetic_arrays(1, 1, 0)[5].astype(np.float64)
    rays = _camera_rays(camera, width, height)
    s, obj = _ray_depth(rays, _AXES, gt)
    x, y = rays[..., 0] * _PLANE_Z, rays[..., 1] * _PLANE_Z
    plane = ((x >= _PLANE_X[0]) & (x <= _PLANE_X[1])
             & (y >= _PLANE_Y[0]) & (y <= _PLANE_Y[1]))
    z = np.where(obj, s, _PLANE_Z) + rng.normal(0.0, 0.0005, s.shape)
    depth = np.where(obj | plane, np.clip(np.round(z / depth_scale), 1, 65535),
                     0).astype(np.uint16)
    prob = np.where(obj, round(0.9 / probability_scale),
                    round(0.12 / probability_scale)).astype(np.uint16)
    rgb = np.where(obj[..., None], np.array([200, 60, 40]), np.array([110, 110, 110]))
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    return rgb, depth, prob, gt.astype(np.float32)


def synthetic_edge_map(prob, probability_scale=1e-4):
    """[H, W] uint8 edge image for a rendered frame (255 = free space, 0 =
    edge, as scene.load_scene reads it) from its probability image: the
    object's silhouette boundary, two pixels thick so that an 8-connected
    fill cannot slip through it, and one straight line across the
    background at 85% of the height. Fills are thereby bounded by edges,
    not only by the pixel radius, and the scene points that reproject onto
    an edge pixel are never sampled."""
    obj = prob > round(0.5 / probability_scale)
    h, w = obj.shape
    pad = np.pad(obj, 1, mode="edge")
    windows = [pad[r:r + h, c:c + w] for r in range(3) for c in range(3)]
    boundary = np.logical_or.reduce(windows) & ~np.logical_and.reduce(windows)
    edge = np.full((h, w), 255, np.uint8)
    edge[boundary] = 0
    edge[int(0.85 * h), :] = 0
    return edge


def _edge_of_ids(ids):
    """[H, W] uint8 edge image (255 free, 0 edge) along every boundary of
    the label image `ids`, two pixels thick so that an 8-connected fill
    cannot slip through it."""
    h, w = ids.shape
    pad = np.pad(ids, 1, mode="edge")
    windows = [pad[r:r + h, c:c + w] for r in range(3) for c in range(3)]
    boundary = np.logical_or.reduce([win != ids for win in windows])
    edge = np.full((h, w), 255, np.uint8)
    edge[boundary] = 0
    return edge


def _write_gt(gt_dir, poses, cam, depth_scale):
    """Ground truth for image 0: a pose file a pose (12 floats, the
    artifact format) and BOP's scene_gt.json and scene_camera.json.
    `poses` is [(obj_id, file tag, 4x4 model->camera pose)]."""
    import json

    os.makedirs(gt_dir, exist_ok=True)
    bop = []
    for obj_id, tag, g in poses:
        with open(os.path.join(gt_dir, f"best_pose_candidate_{tag}.txt"), "w") as f:
            f.write(" ".join(f"{g[r, c]:.9g}" for r in range(3) for c in range(4)) + "\n")
        bop.append({"cam_R_m2c": [float(v) for v in g[:3, :3].reshape(-1)],
                    "cam_t_m2c": [float(v) * 1000.0 for v in g[:3, 3]],
                    "obj_id": obj_id})
    fx, cx, fy, cy = cam.as_tuple()
    with open(os.path.join(gt_dir, "scene_gt.json"), "w") as f:
        json.dump({"0": bop}, f)
    with open(os.path.join(gt_dir, "scene_camera.json"), "w") as f:
        json.dump({"0": {"cam_K": [fx, 0.0, cx, 0.0, fy, cy, 0.0, 0.0, 1.0],
                         "depth_scale": depth_scale * 1000.0}}, f)


def _packed_poses(seed):
    """(floor 4x4 pose, [4x4 model->camera pose of each box]) of the
    packed scene: a bin floor 0.55 m ahead of the camera, facing it and
    tilted 30 degrees about its x axis, and the boxes PACKED_BOX lying on
    it (their z axis along the floor normal) in the PACKED_GRID of columns
    x rows with `gap` metres between neighbours, each turned by a seeded
    few degrees about the floor normal."""
    rng = np.random.default_rng(seed)
    cols, rows, gap = PACKED_GRID
    dims = PACKED_BOX
    a = np.radians(30.0)
    tilt = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    floor = np.eye(4)
    floor[:3, :3] = tilt @ np.diag([1.0, -1.0, -1.0])     # z toward the camera
    floor[:3, 3] = (0.0, 0.0, 0.55)
    boxes = []
    for r in range(rows):
        for c in range(cols):
            local = _pose(rng.uniform(-0.06, 0.06),
                          ((c - (cols - 1) / 2) * (dims[0] + gap),
                           (r - (rows - 1) / 2) * (dims[1] + gap), dims[2] / 2))
            boxes.append((floor @ local.astype(np.float64)).astype(np.float32))
    return floor.astype(np.float32), boxes


def write_synthetic_packed_scene(root, object_name="packed_box", scale=1.0,
                                 num_source_points=30000, seed=0):
    """Write the bin-of-boxes scene of the `packed` preset: copies of the
    box PACKED_BOX on a bin floor (_packed_poses), rendered through the
    preset's camera at its depth scale (1/8000) with 0.5 mm depth noise,
    and the box's source cloud (`num_source_points` points on its faces,
    in metres), as the command-line tools read them:

        <root>/models/<object>/textured_vertices.ply
        <root>/scene/{rgb.png, depth.png}
        <root>/scene/probability_maps/<object>.png   (0.9 on every box, 0.12
                                                      on the floor)
        <root>/scene/probability_maps/edge.png       (every box boundary:
                                                      the instance path)
        <root>/gt/best_pose_candidate_<object>_<i>.txt, scene_gt.json,
        scene_camera.json                            (one pose a box)

    Pixels off the floor's bin (0.5 x 0.34 m) have no depth. The flat
    faces make the coplanar PPF bins dense: after `model-preprocess
    --preset packed` (5 mm voxels, the default 30,000 source points) the
    densest bin union of the box holds 23,062 pairs
    (as chip_smoke.py's densest_bin_union counts it), above the preset's 16,384-pair tier, so
    bases on a face run the banded top tier. `scale` shrinks the image and
    the camera
    together (0.25 gives 160x120). Returns (scene directory, MatchConfig
    of the preset at that image size, [4x4 model->camera pose of each
    box])."""
    cfg = get_preset("packed").match
    cam = CameraIntrinsics(*(v * scale for v in cfg.camera.as_tuple()))
    cfg = dataclasses.replace(cfg, camera=cam,
                              image_width=int(round(cfg.image_width * scale)),
                              image_height=int(round(cfg.image_height * scale)))
    h, w = cfg.image_height, cfg.image_width
    rays = _camera_rays(cam.as_tuple(), w, h)
    floor, boxes = _packed_poses(seed)
    f64 = floor.astype(np.float64)
    n_f, p_f = f64[:3, 2], f64[:3, 3]
    s_floor = (n_f @ p_f) / (rays @ n_f)                # ray-plane hit depth
    on_floor = rays * s_floor[..., None] - p_f
    u, v = on_floor @ f64[:3, 0], on_floor @ f64[:3, 1]
    in_bin = (np.abs(u) <= 0.25) & (np.abs(v) <= 0.17) & (s_floor > 0)
    depth_f = np.where(in_bin, s_floor, np.inf)
    seen = np.full((h, w), -1)
    for i, g in enumerate(boxes):
        s, hit = _box_depth(rays, PACKED_BOX, g.astype(np.float64))
        nearer = hit & (s < depth_f)
        depth_f = np.where(nearer, s, depth_f)
        seen = np.where(nearer, i, seen)
    rng = np.random.default_rng(seed)
    z = depth_f + rng.normal(0.0, 0.0005, depth_f.shape)
    depth = np.where(np.isfinite(depth_f),
                     np.clip(np.round(z / cfg.depth_scale), 1, 65535), 0).astype(np.uint16)
    on, off = round(0.9 / cfg.probability_scale), round(0.12 / cfg.probability_scale)
    prob = np.where(seen >= 0, on, off).astype(np.uint16)
    rgb = np.where((seen >= 0)[..., None], np.array([230, 230, 235]), np.array([70, 90, 120]))
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)

    scene_dir = os.path.join(root, "scene")
    maps = os.path.join(scene_dir, "probability_maps")
    model_dir = os.path.join(root, "models", object_name)
    for d in (maps, model_dir):
        os.makedirs(d, exist_ok=True)
    image.write_rgb(os.path.join(scene_dir, "rgb.png"), rgb)
    image.write_u16(os.path.join(scene_dir, "depth.png"), depth)
    image.write_u16(os.path.join(maps, f"{object_name}.png"), prob)
    image.write_u8(os.path.join(maps, "edge.png"), _edge_of_ids(seen))
    pos, nrm = _box(np.random.default_rng(seed), num_source_points, PACKED_BOX)
    col = np.tile(np.array([230.0, 230.0, 235.0], np.float32), (num_source_points, 1))
    ply.write_ply(os.path.join(model_dir, "textured_vertices.ply"), pos, nrm, col)
    _write_gt(os.path.join(root, "gt"),
              [(1, f"{object_name}_{i}", g) for i, g in enumerate(boxes)],
              cam, cfg.depth_scale)
    return scene_dir, cfg, boxes


def write_synthetic_scene(root, object_name="synthetic_shell", preset="ycb",
                          scale=1.0, num_source_points=8000, seed=0,
                          edge=False):
    """Write a synthetic RGB-D scene and its object's source cloud (the
    shell of synthetic_arrays, `num_source_points` points) as the
    command-line tools read them:

        <root>/models/<object>/textured_vertices.ply
        <root>/scene/{rgb.png, depth.png, probability_maps/<object>.png}

    and, with `edge=True`, probability_maps/edge.png (`synthetic_edge_map`),
    which makes the scene an instance-path one. `scale` shrinks the image and the camera together (0.25 gives 160x120).
    The depth is written at the preset's depth scale, and the source cloud
    in the preset's model units: metres, or millimetres for `linemod`
    (model_scale 1/1000), as LINEMOD's models are.
    Returns (scene directory, MatchConfig of the preset at that image size,
    gt 4x4 model->camera pose in metres)."""
    units = np.float32(1.0 / get_preset(preset).preprocess.model_scale)
    cfg = get_preset(preset).match
    cam = CameraIntrinsics(*(v * scale for v in cfg.camera.as_tuple()))
    cfg = dataclasses.replace(cfg, camera=cam,
                              image_width=int(round(cfg.image_width * scale)),
                              image_height=int(round(cfg.image_height * scale)))
    rgb, depth, prob, gt = synthetic_rgbd(
        cam.as_tuple(), cfg.image_width, cfg.image_height, cfg.depth_scale,
        cfg.probability_scale, seed)
    model_dir = os.path.join(root, "models", object_name)
    scene_dir = os.path.join(root, "scene")
    os.makedirs(model_dir, exist_ok=True)
    os.makedirs(os.path.join(scene_dir, "probability_maps"), exist_ok=True)
    pos, nrm = synthetic_arrays(num_source_points, num_source_points, seed)[:2]
    col = np.tile(np.array([200.0, 60.0, 40.0], np.float32), (num_source_points, 1))
    ply.write_ply(os.path.join(model_dir, "textured_vertices.ply"), pos * units, nrm, col)
    image.write_rgb(os.path.join(scene_dir, "rgb.png"), rgb)
    image.write_u16(os.path.join(scene_dir, "depth.png"), depth)
    image.write_u16(os.path.join(scene_dir, "probability_maps",
                                 f"{object_name}.png"), prob)
    if edge:
        image.write_u8(os.path.join(scene_dir, "probability_maps", "edge.png"),
                       synthetic_edge_map(prob, cfg.probability_scale))
    return scene_dir, cfg, gt


def write_synthetic_multi_scene(root, preset="ycb", scale=1.0,
                                num_source_points=8000, seed=0, edge=False):
    """Write one RGB-D frame holding the three shells of MULTI_SHELLS, each
    at its own pose over the plane of synthetic_rgbd (a z-buffer decides
    which surface a pixel sees; 0.5 mm depth noise), as the command-line
    tools read it:

        <root>/models/<object>/textured_vertices.ply     (each object)
        <root>/scene/{rgb.png, depth.png}
        <root>/scene/probability_maps/<object>.png      (0.9 on the object,
                                                          0.12 elsewhere)
        <root>/gt/best_pose_candidate_<object>.txt      (12 floats, the
                                                          artifact format)
        <root>/gt/scene_gt.json, scene_camera.json      (BOP, image 0,
                                                          obj_id 1, 2, 3)

    `edge=True` adds probability_maps/edge.png (synthetic_edge_map of the
    union of the silhouettes): the instance path. `scale` shrinks the image
    and the camera together (0.25 gives 160x120). Returns (scene directory,
    MatchConfig of the preset at that image size, {object: gt 4x4
    model->camera pose})."""
    cfg = get_preset(preset).match
    cam = CameraIntrinsics(*(v * scale for v in cfg.camera.as_tuple()))
    cfg = dataclasses.replace(cfg, camera=cam,
                              image_width=int(round(cfg.image_width * scale)),
                              image_height=int(round(cfg.image_height * scale)))
    h, w = cfg.image_height, cfg.image_width
    rays = _camera_rays(cam.as_tuple(), w, h)
    depth_f = np.full((h, w), 0.9025)
    seen = np.full((h, w), -1)                        # object index, -1 = plane
    gts = {}
    for i, (name, axes, th, t) in enumerate(MULTI_SHELLS):
        gts[name] = _pose(th, t)
        s, hit = _ray_depth(rays, axes, gts[name].astype(np.float64))
        nearer = hit & (s < depth_f)
        depth_f = np.where(nearer, s, depth_f)
        seen = np.where(nearer, i, seen)
    rng = np.random.default_rng(seed)
    z = depth_f + rng.normal(0.0, 0.0005, depth_f.shape)
    depth = np.clip(np.round(z / cfg.depth_scale), 1, 65535).astype(np.uint16)
    colours = np.array([[110, 110, 110], [200, 60, 40], [40, 160, 60], [50, 70, 200]])
    rgb = colours[seen + 1]
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    on, off = round(0.9 / cfg.probability_scale), round(0.12 / cfg.probability_scale)

    scene_dir = os.path.join(root, "scene")
    maps = os.path.join(scene_dir, "probability_maps")
    gt_dir = os.path.join(root, "gt")
    for d in (maps, gt_dir):
        os.makedirs(d, exist_ok=True)
    image.write_rgb(os.path.join(scene_dir, "rgb.png"), rgb)
    image.write_u16(os.path.join(scene_dir, "depth.png"), depth)
    src_rng = np.random.default_rng(seed)
    for i, (name, axes, _th, _t) in enumerate(MULTI_SHELLS):
        image.write_u16(os.path.join(maps, f"{name}.png"),
                        np.where(seen == i, on, off).astype(np.uint16))
        model_dir = os.path.join(root, "models", name)
        os.makedirs(model_dir, exist_ok=True)
        pos, nrm = _shell(src_rng, num_source_points, axes)
        col = np.tile(colours[i + 1].astype(np.float32), (num_source_points, 1))
        ply.write_ply(os.path.join(model_dir, "textured_vertices.ply"), pos, nrm, col)
    _write_gt(gt_dir, [(i + 1, name, gts[name]) for i, (name, *_r) in enumerate(MULTI_SHELLS)],
              cam, cfg.depth_scale)
    if edge:
        union = np.where(seen >= 0, on, off)
        image.write_u8(os.path.join(maps, "edge.png"),
                       synthetic_edge_map(union, cfg.probability_scale))
    return scene_dir, cfg, gts
