"""The benchmark's frames: RGB-D scenes and model source clouds, made from a
seed and written as the port's command-line tools read them.

A frozen copy of the port's synthetic writers (PNG encoder, ascii PLY
writer, the half-ellipsoid shell, the bin of boxes, the three-shell scene),
extended with a pose per frame, so that a change to the port's own
writers never changes what the benchmark measures. benchmark/tests holds
each copy to the port's original on fixed inputs.

Every configuration has eight fixed frames (`frame_poses`, and noise drawn
from the layout): the seed orders them, so two seeds give the same work in
another order.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib

import numpy as np

# ---------------------------------------------------------------- PNG, PLY

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _encode(path, px, ctype, depth):
    h = px.shape[0]
    if px.dtype == np.uint16:
        rows = px.astype(">u2").reshape(h, -1).view(np.uint8)
    else:
        rows = px.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", px.shape[1], h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def write_u8(path, img):
    _encode(path, np.ascontiguousarray(img, dtype=np.uint8), 0, 8)


def write_rgb(path, img):
    _encode(path, np.ascontiguousarray(img, dtype=np.uint8), 2, 8)


def write_u16(path, img):
    _encode(path, np.ascontiguousarray(img, dtype=np.uint16), 0, 16)


def write_ply(path, pos, normal, rgb):
    """Ascii vertex cloud (float32 x y z nx ny nz, uchar colour), %.9g: a
    float32 reads back exactly."""
    pos = np.asarray(pos, np.float32)
    normal = np.asarray(normal, np.float32)
    rgbu = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8)
    names = ["x", "y", "z", "nx", "ny", "nz"]
    header = ["ply", "format ascii 1.0", "comment model_matching_tpu_torch generated",
              f"element vertex {pos.shape[0]}"]
    header += [f"property float {n}" for n in names]
    header += [f"property uchar {n}" for n in ("red", "green", "blue")]
    header.append("end_header")
    cols = np.column_stack([pos.astype(np.float64), normal.astype(np.float64),
                            rgbu.astype(np.float64)])
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        np.savetxt(f, cols, fmt="%.9g")


# ------------------------------------------------------------ the objects

SHELL_AXES = (0.08, 0.065, 0.05)
# the three shells of the multi-object scene: name, semi-axes, turn about
# the camera's z axis (radians), translation (metres)
MULTI_SHELLS = (
    ("shell_a", SHELL_AXES, 0.7, (0.05, -0.1, 0.8)),
    ("shell_b", (0.05, 0.09, 0.04), -0.4, (-0.12, 0.06, 0.82)),
    ("shell_c", (0.065, 0.045, 0.035), 1.9, (0.13, 0.06, 0.78)),
)
PACKED_BOX = (0.095, 0.062, 0.032)
PACKED_GRID = (4, 2, 0.012)
# the table top under the shells: 0.9025 m from the camera, facing it
PLANE_Z, PLANE_X, PLANE_Y = 0.9025, (-0.27, 0.28), (-0.21, 0.21)


def shell_points(rng, n, axes):
    """n points of the half-ellipsoid shell (z <= 0) and their outward
    normals, float32."""
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(np.pi / 2, np.pi, n)
    a, b, c = axes
    pos = np.stack([a * np.sin(v) * np.cos(u), b * np.sin(v) * np.sin(u),
                    c * np.cos(v)], axis=1).astype(np.float32)
    nrm = np.stack([np.sin(v) * np.cos(u) / a, np.sin(v) * np.sin(u) / b,
                    np.cos(v) / c], axis=1).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pos, nrm


def box_points(rng, n, dims):
    """n points on the faces of a box centred at the origin (each face in
    proportion to its area) and their outward normals, float32."""
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


def pose(th, t):
    """4x4 float32: a turn of `th` radians about z, then translation t."""
    g = np.eye(4, dtype=np.float32)
    g[:3, :3] = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                          [0, 0, 1]], np.float32)
    g[:3, 3] = t
    return g


def _ray_depth(d, axes, gt):
    rot, t = gt[:3, :3], gt[:3, 3]
    o_m = -rot.T @ t
    d_m = d @ rot
    inv2 = 1.0 / np.square(np.asarray(axes))
    qa = (d_m * d_m * inv2).sum(-1)
    qb = 2.0 * (d_m * o_m * inv2).sum(-1)
    qc = (o_m * o_m * inv2).sum() - 1.0
    disc = qb * qb - 4 * qa * qc
    s = (-qb - np.sqrt(np.maximum(disc, 0.0))) / (2 * qa)
    z_model = o_m[2] + s * d_m[..., 2]
    return s, (disc > 0) & (s > 0) & (z_model <= 0)


def _box_depth(d, dims, gt):
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


def camera_rays(camera, width, height):
    fx, cx, fy, cy = camera
    rows, cols = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    return np.stack([(cols - cx) / fx, (rows - cy) / fy, np.ones_like(cols, float)], -1)


def edge_of_ids(ids):
    """[H, W] uint8 edge image (255 free, 0 edge) along every boundary of the
    label image `ids`, two pixels thick."""
    h, w = ids.shape
    pad = np.pad(ids, 1, mode="edge")
    windows = [pad[r:r + h, c:c + w] for r in range(3) for c in range(3)]
    edge = np.full((h, w), 255, np.uint8)
    edge[np.logical_or.reduce([win != ids for win in windows])] = 0
    return edge


# -------------------------------------------------------------- renderers

def render_shells(camera, width, height, depth_scale, prob_scale, shells, rng):
    """The shells [(axes, 4x4 pose)] over the table top, through a z-buffer,
    with 0.5 mm depth noise. Returns (rgb, depth u16, [prob u16 per shell],
    label image: shell index, -1 table, -2 nothing)."""
    rays = camera_rays(camera, width, height)
    x, y = rays[..., 0] * PLANE_Z, rays[..., 1] * PLANE_Z
    plane = ((x >= PLANE_X[0]) & (x <= PLANE_X[1])
             & (y >= PLANE_Y[0]) & (y <= PLANE_Y[1]))
    depth_f = np.where(plane, PLANE_Z, np.inf)
    seen = np.where(plane, -1, -2)
    for i, (axes, g) in enumerate(shells):
        s, hit = _ray_depth(rays, axes, g.astype(np.float64))
        nearer = hit & (s < depth_f)
        depth_f = np.where(nearer, s, depth_f)
        seen = np.where(nearer, i, seen)
    z = depth_f + rng.normal(0.0, 0.0005, depth_f.shape)
    depth = np.where(np.isfinite(depth_f), np.clip(np.round(z / depth_scale), 1, 65535),
                     0).astype(np.uint16)
    on, off = round(0.9 / prob_scale), round(0.12 / prob_scale)
    probs = [np.where(seen == i, on, off).astype(np.uint16) for i in range(len(shells))]
    colours = np.array([[110, 110, 110], [200, 60, 40], [40, 160, 60], [50, 70, 200]])
    rgb = colours[np.maximum(seen, -1) + 1]
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    return rgb, depth, probs, seen


def render_bin(camera, width, height, depth_scale, prob_scale, floor, boxes, rng):
    """The boxes PACKED_BOX at `boxes` poses on a 0.5 x 0.34 m bin floor at
    `floor`, with 0.5 mm depth noise. Returns (rgb, depth u16, prob u16,
    label image: box index, -1 floor or nothing)."""
    rays = camera_rays(camera, width, height)
    f64 = floor.astype(np.float64)
    n_f, p_f = f64[:3, 2], f64[:3, 3]
    s_floor = (n_f @ p_f) / (rays @ n_f)
    on_floor = rays * s_floor[..., None] - p_f
    u, v = on_floor @ f64[:3, 0], on_floor @ f64[:3, 1]
    in_bin = (np.abs(u) <= 0.25) & (np.abs(v) <= 0.17) & (s_floor > 0)
    depth_f = np.where(in_bin, s_floor, np.inf)
    seen = np.full((height, width), -1)
    for i, g in enumerate(boxes):
        s, hit = _box_depth(rays, PACKED_BOX, g.astype(np.float64))
        nearer = hit & (s < depth_f)
        depth_f = np.where(nearer, s, depth_f)
        seen = np.where(nearer, i, seen)
    z = depth_f + rng.normal(0.0, 0.0005, depth_f.shape)
    depth = np.where(np.isfinite(depth_f),
                     np.clip(np.round(z / depth_scale), 1, 65535), 0).astype(np.uint16)
    on, off = round(0.9 / prob_scale), round(0.12 / prob_scale)
    prob = np.where(seen >= 0, on, off).astype(np.uint16)
    rgb = np.where((seen >= 0)[..., None], np.array([230, 230, 235]), np.array([70, 90, 120]))
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    return rgb, depth, prob, seen


def bin_poses(layout_seed):
    """(floor 4x4, [4x4 pose of each box]): a bin floor 0.55 m ahead, tilted
    30 degrees about x, with the boxes in the PACKED_GRID, each turned by a
    few degrees drawn from `layout_seed`."""
    rng = np.random.default_rng(layout_seed)
    cols, rows, gap = PACKED_GRID
    dims = PACKED_BOX
    a = np.radians(30.0)
    tilt = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    floor = np.eye(4)
    floor[:3, :3] = tilt @ np.diag([1.0, -1.0, -1.0])
    floor[:3, 3] = (0.0, 0.0, 0.55)
    boxes = []
    for r in range(rows):
        for c in range(cols):
            local = pose(rng.uniform(-0.06, 0.06),
                         ((c - (cols - 1) / 2) * (dims[0] + gap),
                          (r - (rows - 1) / 2) * (dims[1] + gap), dims[2] / 2))
            boxes.append((floor @ local.astype(np.float64)).astype(np.float32))
    return floor.astype(np.float32), boxes


# ------------------------------------------------------------ the frames

@dataclasses.dataclass
class Frame:
    """One written frame: its files, the raw arrays written to them (the
    reference reads these), and the objects' ground-truth poses."""
    index: int
    layout: int
    scene_dir: str
    rgb: np.ndarray
    depth: np.ndarray
    probs: list            # [H, W] uint16, one per object
    edge: np.ndarray       # [H, W] uint8 (zeros when no edge map is written)
    has_edge: bool
    truth: list            # 4x4 poses (every box of a bin frame)

    def paths(self, objects):
        maps = os.path.join(self.scene_dir, "probability_maps")
        edge = os.path.join(maps, "edge.png") if self.has_edge else None
        return (os.path.join(self.scene_dir, "rgb.png"),
                os.path.join(self.scene_dir, "depth.png"),
                [os.path.join(maps, f"{o}.png") for o in objects], edge)


def frame_poses(kind, k):
    """The k-th of eight fixed frame layouts of a scene kind: the same set
    for every seed."""
    if kind == "shell":
        phi = 3 * k * 2 * np.pi / 8
        t = (0.1 * np.cos(phi), 0.07 * np.sin(phi), 0.8 + 0.01 * (k % 3 - 1))
        return [(SHELL_AXES, pose(0.7 + k * 2 * np.pi / 8, t))]
    if kind == "shells3":
        out = []
        for i, (_n, axes, th, t) in enumerate(MULTI_SHELLS):
            dt = 0.01 * np.array([np.cos(k + i), np.sin(k + 2 * i), 0.0])
            out.append((axes, pose(th + k * 2 * np.pi / 8 * (i + 1), np.asarray(t) + dt)))
        return out
    if kind == "bin":
        return bin_poses(k)
    raise ValueError(f"unknown scene kind {kind!r}")


def object_names(kind):
    return {"shell": ["shell"], "shells3": [s[0] for s in MULTI_SHELLS],
            "bin": ["box"]}[kind]


def source_clouds(kind, n):
    """{object: (pos, normal, rgb)} source clouds, fixed for every seed."""
    rng = np.random.default_rng(0)
    if kind == "bin":
        pos, nrm = box_points(rng, n, PACKED_BOX)
        return {"box": (pos, nrm, np.tile([230.0, 230.0, 235.0], (n, 1)))}
    colours = [[200.0, 60.0, 40.0], [40.0, 160.0, 60.0], [50.0, 70.0, 200.0]]
    shells = [("shell", SHELL_AXES)] if kind == "shell" else [(s[0], s[1]) for s in MULTI_SHELLS]
    out = {}
    for i, (name, axes) in enumerate(shells):
        pos, nrm = shell_points(rng, n, axes)
        out[name] = (pos, nrm, np.tile(colours[i], (n, 1)))
    return out


def write_models(root, kind, n):
    """Write each object's textured_vertices.ply under root/models/<object>;
    returns {object: (pos, normal)} as written."""
    out = {}
    for name, (pos, nrm, col) in source_clouds(kind, n).items():
        d = os.path.join(root, "models", name)
        os.makedirs(d, exist_ok=True)
        write_ply(os.path.join(d, "textured_vertices.ply"), pos, nrm, col)
        out[name] = (pos, nrm)
    return out


def write_frame(root, kind, layout, order_index, camera, width, height,
                depth_scale, prob_scale, edge):
    """Write layout `layout` as frame `order_index` of a run, under
    root/frame<order_index>. Its noise is the layout's own: the depth noise
    moves which bases the sampler draws, and so the work."""
    rng = np.random.default_rng([layout, 1])
    objects = object_names(kind)
    if kind == "bin":
        floor, boxes = frame_poses(kind, layout)
        rgb, depth, prob, seen = render_bin(camera, width, height, depth_scale,
                                            prob_scale, floor, boxes, rng)
        probs, truth = [prob], boxes
    else:
        shells = frame_poses(kind, layout)
        rgb, depth, probs, seen = render_shells(camera, width, height, depth_scale,
                                                prob_scale, shells, rng)
        truth = [g for _a, g in shells]
    scene_dir = os.path.join(root, f"frame{order_index}")
    maps = os.path.join(scene_dir, "probability_maps")
    os.makedirs(maps, exist_ok=True)
    write_rgb(os.path.join(scene_dir, "rgb.png"), rgb)
    write_u16(os.path.join(scene_dir, "depth.png"), depth)
    for name, p in zip(objects, probs):
        write_u16(os.path.join(maps, f"{name}.png"), p)
    # no edge map reads as zeros, as the port reads a missing one
    edge_img = edge_of_ids(seen) if edge else np.zeros(depth.shape, np.uint8)
    if edge:
        write_u8(os.path.join(maps, "edge.png"), edge_img)
    return Frame(order_index, layout, scene_dir, rgb, depth, probs, edge_img, edge, truth)


def write_frames(root, kind, n_frames, seed, camera, width, height, depth_scale,
                 prob_scale, edge):
    """The run's frames: the fixed layouts, noise and all, in an order drawn
    from `seed`."""
    order = np.random.default_rng([seed, 7]).permutation(n_frames)
    return [write_frame(root, kind, int(layout), i, camera, width, height,
                        depth_scale, prob_scale, edge)
            for i, layout in enumerate(order)]
