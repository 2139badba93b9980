"""The model pack: centered search cloud, its PPF table and endpoint rows.

Counterpart of ``model_matching_tpu/model.py``: ``ModelPack``,
``build_pair_ep`` and ``load_model_pack``, which reads the artifact pair
``model_search.ply`` + ``ppf_table.npz`` that model preprocessing writes
(by either package).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .io import ply
from .ppf_table import PPFTable, load_ppf_table, resize_table
from .utils.device import require

# Shape floors of `standardize=True`: every model whose tables fit inside
# them gets identical table shapes and probe bounds (the JAX package's
# values, so both packages pad alike).
_EXIST_FLOOR = 1 << 20
_BIN_FLOOR = 1 << 19
_PAIRS_FLOOR = 1 << 20
_DIRECT_FLOOR = 1 << 21


def _bucket_probes(p: int) -> int:
    return max(16, -(-p // 8) * 8)


@dataclasses.dataclass
class ModelPack:
    pos: torch.Tensor       # [M, 3] centered, padded
    normal: torch.Tensor    # [M, 3]
    rgb: torch.Tensor       # [M, 3]
    valid: torch.Tensor     # [M] bool
    centroid: torch.Tensor  # [3]
    table: PPFTable
    # [total_pairs padded to 4, 6] f32 endpoint rows (a.xyz, b.xyz) in the
    # centered frame; None = built on demand (estimator._pair_ep_of)
    pair_ep: Optional[torch.Tensor] = None

    def count(self):
        return self.valid.sum(dtype=torch.int32)

    def to(self, device) -> "ModelPack":
        return dataclasses.replace(
            self, pos=self.pos.to(device), normal=self.normal.to(device),
            rgb=self.rgb.to(device), valid=self.valid.to(device),
            centroid=self.centroid.to(device), table=self.table.to(device),
            pair_ep=None if self.pair_ep is None else self.pair_ep.to(device),
        )


def build_pair_ep(centered_pos: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """[total_pairs (padded to 4), 6] f32 rows (a.xyz, b.xyz): the raw pair
    endpoints, padded to a multiple of 4 rows so the dense congruent tiers
    can view the table as [P/4, 24] and read four pairs per row."""
    ep = torch.cat(
        [centered_pos[pairs[:, 0].long()], centered_pos[pairs[:, 1].long()]], dim=1
    )
    pad = (-ep.shape[0]) % 4
    if pad:
        ep = torch.cat([ep, ep.new_zeros((pad, 6))])
    return ep


def load_model_pack(model_ply_path: str, table_path: str, capacity: int,
                    standardize: bool = False, device="cuda") -> ModelPack:
    """The preprocessed model on `device` (the card unless the caller asks
    for the CPU). standardize=True pads the tables to common shape floors
    and buckets the probe bounds and the cloud size, as the JAX package
    does for its serve and batch paths; single-object runs keep exact-size
    tables. The table goes to `device` first, so a standardizing rebuild
    runs there."""
    dev = require(device)
    pos, normal, rgb = ply.read_ply_cloud(model_ply_path, scale=1.0)
    if normal is None:
        raise ValueError(f"{model_ply_path} has no normals; run model-preprocess")
    n = pos.shape[0]
    if n > capacity:
        raise ValueError(
            f"model has {n} points > capacity {capacity}; raise max_model_points"
        )
    table = load_ppf_table(table_path)[0].to(dev)
    if standardize:
        pairs_size = max(_PAIRS_FLOOR, 1 << int(np.ceil(np.log2(
            max(table.pairs.shape[0], 2)))))
        if (
            table.exist_keys.shape[0] < _EXIST_FLOOR
            or table.bin_keys.shape[0] < _BIN_FLOOR
            or table.pairs.shape[0] != pairs_size
            or (table.bin_direct is not None
                and table.bin_direct.shape[0] < _DIRECT_FLOOR)
        ):
            table = resize_table(
                table,
                max(_EXIST_FLOOR, table.exist_keys.shape[0]),
                max(_BIN_FLOOR, table.bin_keys.shape[0]),
                pairs_size,
                direct_size=_DIRECT_FLOOR,
            )
        table = dataclasses.replace(
            table,
            exist_max_probes=_bucket_probes(table.exist_max_probes),
            bin_max_probes=_bucket_probes(table.bin_max_probes),
        )

    centroid = pos.mean(axis=0)
    pos = pos - centroid
    # pad to the next multiple of 128 lanes, or with standardize to a
    # power of two of at least 512 (capacity is an upper bound only)
    if standardize:
        padded = min(capacity, max(512, 1 << int(np.ceil(np.log2(max(n, 2))))))
    else:
        padded = min(capacity, max(128, -(-n // 128) * 128))

    def pad(a):
        out = np.zeros((padded, a.shape[1]), dtype=np.float32)
        out[:n] = a
        return torch.from_numpy(out)

    valid = torch.zeros(padded, dtype=torch.bool)
    valid[:n] = True
    model = ModelPack(
        pos=pad(pos),
        normal=pad(normal),
        rgb=pad(rgb if rgb is not None else np.full((n, 3), -1.0, np.float32)),
        valid=valid,
        centroid=torch.from_numpy(centroid.astype(np.float32)),
        table=table,
    ).to(dev)
    # built from the padded positions; pairs only reference real points
    return dataclasses.replace(model, pair_ep=build_pair_ep(model.pos, table.pairs))
