"""Debug visualization: probability heatmaps and pose overlays.

Counterpart of ``model_matching_tpu/viz.py``, numpy over the port's own
PNG codec (io/image.py): per-point probabilities block-splatted onto the
image grid under a JET colormap with circles on sampled points, and the
posed model projected into the RGB image. Opt-in debug artifacts of
``stocs-single --heatmap``.
"""

from __future__ import annotations

import numpy as np

from .io.image import read_rgb, write_rgb


def _jet(x: np.ndarray) -> np.ndarray:
    """Minimal JET colormap (x in [0,1]) -> uint8 RGB."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def visualize_heatmap(
    pixels: np.ndarray,        # [N, 2] (row, col)
    probabilities: np.ndarray,  # [N]
    samples,                   # indices to circle
    save_location: str,
    image_width: int,
    image_height: int,
    block_size: int = 8,
) -> None:
    """Block-splat per-point probabilities, JET colormap, circled samples."""
    img = np.zeros((image_height, image_width), np.float32)
    half = block_size // 2
    for (r, c), p in zip(pixels, probabilities):
        r0, r1 = max(0, r - half), min(image_height, r + half + 1)
        c0, c1 = max(0, c - half), min(image_width, c + half + 1)
        img[r0:r1, c0:c1] = p
    heat = _jet(img)

    # circle the samples
    theta = np.linspace(0, 2 * np.pi, 64)
    ring = np.stack([np.sin(theta), np.cos(theta)], axis=1)
    for s in samples:
        r, c = pixels[s]
        for radius in (7.0, 8.0):
            rr = np.clip((r + ring[:, 0] * radius).astype(int), 0, image_height - 1)
            cc = np.clip((c + ring[:, 1] * radius).astype(int), 0, image_width - 1)
            heat[rr, cc] = [0, 255, 0]
    write_rgb(save_location, heat)


def overlay_pose(
    rgb_path: str,
    model_pos: np.ndarray,      # [M, 3] original model coordinates
    world_transform: np.ndarray,  # [3..4, 4]
    fx: float, cx: float, fy: float, cy: float,
    save_location: str,
    color=(0, 255, 0),
) -> None:
    """Project the posed model into the RGB image (pose sanity check)."""
    rgb = read_rgb(rgb_path).copy()
    h, w = rgb.shape[:2]
    moved = model_pos @ np.asarray(world_transform)[:3, :3].T + np.asarray(
        world_transform
    )[:3, 3]
    col = (moved[:, 0] * fx / moved[:, 2] + cx).astype(int)
    row = (moved[:, 1] * fy / moved[:, 2] + cy).astype(int)
    ok = (row >= 0) & (row < h) & (col >= 0) & (col < w) & (moved[:, 2] > 0)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            rgb[np.clip(row[ok] + dr, 0, h - 1),
                np.clip(col[ok] + dc, 0, w - 1)] = color
    write_rgb(save_location, rgb)
