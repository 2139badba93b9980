"""Structure-of-arrays containers (counterpart of
``model_matching_tpu/types.py``): a padded point cloud and batched pose
hypotheses, as torch tensors on an explicit device."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .utils import trace
from .utils.device import require


@dataclasses.dataclass
class PointCloud:
    """Padded SoA cloud. All tensors share leading dim N (the pad capacity);
    `valid` marks live entries."""

    pos: torch.Tensor         # [N, 3] float32
    normal: torch.Tensor      # [N, 3] float32 (unit where valid)
    rgb: torch.Tensor         # [N, 3] float32 (0..255; -1 if unset)
    pixel: torch.Tensor       # [N, 2] int32 (row, col); -1 if unset
    class_prob: torch.Tensor  # [N] float32
    edge_prob: torch.Tensor   # [N] float32
    valid: torch.Tensor       # [N] bool

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    @staticmethod
    def from_numpy(
        pos: np.ndarray,
        normal: Optional[np.ndarray] = None,
        rgb: Optional[np.ndarray] = None,
        pixel: Optional[np.ndarray] = None,
        class_prob: Optional[np.ndarray] = None,
        edge_prob: Optional[np.ndarray] = None,
        capacity: Optional[int] = None,
        device="cuda",
    ) -> "PointCloud":
        """The cloud padded to `capacity` (default: its size) on `device`
        (the card unless the caller asks for the CPU)."""
        dev = require(device)
        n = pos.shape[0]
        cap = capacity if capacity is not None else n
        if n > cap:
            raise ValueError(f"{n} points exceed capacity {cap}")

        def padded(a, fill, dtype, width=None):
            out = np.full((cap,) if width is None else (cap, width), fill, dtype=dtype)
            if a is not None:
                out[:n] = a
            return torch.from_numpy(out).to(dev)

        valid = np.zeros((cap,), dtype=bool)
        valid[:n] = True
        return PointCloud(
            pos=padded(pos, 0.0, np.float32, 3),
            normal=padded(normal, 0.0, np.float32, 3),
            rgb=padded(rgb, -1.0, np.float32, 3),
            pixel=padded(pixel, -1, np.int32, 2),
            class_prob=padded(class_prob, 0.0, np.float32),
            edge_prob=padded(edge_prob, 0.0, np.float32),
            valid=torch.from_numpy(valid).to(dev),
        )

    def to_numpy_trimmed(self) -> dict:
        """Host copy with the padding removed."""
        trace.count("host_reads", len(dataclasses.fields(self)))
        valid = self.valid.cpu().numpy()
        return {f.name: getattr(self, f.name).cpu().numpy()[valid]
                for f in dataclasses.fields(self) if f.name != "valid"}


@dataclasses.dataclass
class PoseCandidates:
    """Batched pose hypotheses. `transform` holds centered-frame
    model->scene transforms (what scoring consumes); `world_transform` the
    un-centered ones."""

    transform: torch.Tensor        # [H, 4, 4] float32
    world_transform: torch.Tensor  # [H, 4, 4] float32
    lcp: torch.Tensor              # [H] float32
    base_index: torch.Tensor       # [H] int32
    valid: torch.Tensor            # [H] bool

    def to(self, device) -> "PoseCandidates":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })
