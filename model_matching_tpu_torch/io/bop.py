"""BOP-format ground truth (scene_gt.json / scene_camera.json).

Counterpart of ``model_matching_tpu/io/bop.py``. The BOP challenge layout
(bop_toolkit docs/bop_datasets_format.md):

    scene_gt.json     {"<im_id>": [{"cam_R_m2c": [9 row-major floats],
                                    "cam_t_m2c": [3 floats, MILLIMETERS],
                                    "obj_id": int}, ...], ...}
    scene_camera.json {"<im_id>": {"cam_K": [9 row-major floats],
                                   "depth_scale": float}, ...}

parsed into the package's conventions: metres, and [4, 4]
model-to-camera matrices in the frame of best_pose_candidate_*.txt, so
`cli eval <est> <scene_gt.json> --im-id N --obj-id K` scores estimates
against a BOP dataset's ground truth.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np


def load_scene_gt(path: str) -> Dict[int, List[dict]]:
    """scene_gt.json -> {im_id: [{"obj_id": int, "pose": [4, 4] float32
    model-to-camera, metres}, ...]}; cam_t_m2c is converted from mm."""
    with open(path) as f:
        raw = json.load(f)
    out: Dict[int, List[dict]] = {}
    for im_id, entries in raw.items():
        lst = []
        for e in entries:
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = np.asarray(e["cam_R_m2c"], np.float64).reshape(3, 3)
            m[:3, 3] = np.asarray(e["cam_t_m2c"], np.float64) / 1000.0
            lst.append({"obj_id": int(e["obj_id"]), "pose": m})
        out[int(im_id)] = lst
    return out


def load_scene_camera(path: str) -> Dict[int, dict]:
    """scene_camera.json -> {im_id: {"K": [3, 3] float64, "depth_scale":
    float, "depth_to_m": float}}. BOP's depth_scale turns the stored
    uint16 depth into millimetres; depth_to_m turns it into metres
    (MatchConfig.depth_scale's convention)."""
    with open(path) as f:
        raw = json.load(f)
    out: Dict[int, dict] = {}
    for im_id, e in raw.items():
        ds = float(e.get("depth_scale", 1.0))
        out[int(im_id)] = {
            "K": np.asarray(e["cam_K"], np.float64).reshape(3, 3),
            "depth_scale": ds,
            "depth_to_m": ds / 1000.0,
        }
    return out


def camera_intrinsics(scene_camera: Dict[int, dict], im_id: int):
    """BOP cam_K -> config.CameraIntrinsics (fx, cx, fy, cy)."""
    from ..config import CameraIntrinsics

    k = scene_camera[im_id]["K"]
    return CameraIntrinsics(fx=float(k[0, 0]), cx=float(k[0, 2]),
                            fy=float(k[1, 1]), cy=float(k[1, 2]))


def gt_poses(scene_gt: Dict[int, List[dict]], im_id: int, obj_id: int) -> np.ndarray:
    """All ground-truth [4, 4] poses of `obj_id` in image `im_id` (a BOP
    image may hold several instances of one object). Raises KeyError if
    the image or the object is absent."""
    entries = scene_gt[im_id]
    poses = [e["pose"] for e in entries if e["obj_id"] == obj_id]
    if not poses:
        raise KeyError(
            f"no ground truth for obj_id={obj_id} in im_id={im_id} "
            f"(present: {sorted({e['obj_id'] for e in entries})})"
        )
    return np.stack(poses).astype(np.float32)
