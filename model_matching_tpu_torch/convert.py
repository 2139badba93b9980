"""Carry state across from the JAX package into the port's packs.

Each function takes any object with the JAX packs' attribute names (a
``model_matching_tpu`` ModelPack, ScenePack, PPFTable, NeighborGrid or
DenseField, or a stand-in with the same fields), reads every array field
with ``np.asarray`` and returns the port's pack on the CPU. It never
imports jax: the arrays arrive through the numpy array protocol. This is
how the tests hand identical state to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import ModelPack
from .ops.densefield import DenseField
from .ops.gridhash import NeighborGrid
from .ppf_table import PPFTable
from .scene import ScenePack


def _t(a):
    """Array-like -> CPU tensor (uint32 words widen to int64); None passes."""
    if a is None:
        return None
    arr = np.array(np.asarray(a), copy=True, order="C")
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    return torch.from_numpy(arr)


def exists_bits(bits) -> torch.Tensor:
    """The JAX package's bit-packed pair-existence matrix ([N, N / 32]
    uint32) as the port holds it: int32 words with the same bit patterns
    (sampling.build_exists_bits)."""
    return torch.from_numpy(np.array(np.asarray(bits), dtype=np.uint32).view(np.int32))


def ppf_table(t) -> PPFTable:
    return PPFTable(
        exist_keys=_t(t.exist_keys), bin_keys=_t(t.bin_keys),
        bin_offset=_t(t.bin_offset), bin_count=_t(t.bin_count),
        pairs=_t(t.pairs), tr_disc=int(t.tr_disc), rot_disc=int(t.rot_disc),
        exist_max_probes=int(t.exist_max_probes),
        bin_max_probes=int(t.bin_max_probes),
        bin_direct=_t(t.bin_direct), exist_direct=_t(t.exist_direct),
    )


def neighbor_grid(g) -> NeighborGrid:
    return NeighborGrid(
        origin=_t(g.origin), dims=_t(g.dims), cell_size=_t(g.cell_size),
        table_keys=_t(g.table_keys), table_offset=_t(g.table_offset),
        table_count=_t(g.table_count), cand_idx=_t(g.cand_idx),
        max_probes=int(g.max_probes), cell_cap=int(g.cell_cap),
        cell_map=_t(g.cell_map), payload=_t(g.payload),
        has_normals=bool(g.has_normals), has_probs=bool(g.has_probs),
    )


def dense_field(f) -> DenseField:
    return DenseField(
        rows=_t(f.rows), origin=_t(f.origin), dims=_t(f.dims),
        cell=_t(f.cell), has_probs=bool(f.has_probs),
    )


def model_pack(m) -> ModelPack:
    return ModelPack(
        pos=_t(m.pos), normal=_t(m.normal), rgb=_t(m.rgb), valid=_t(m.valid),
        centroid=_t(m.centroid), table=ppf_table(m.table),
        pair_ep=_t(m.pair_ep),
    )


def scene_pack(s) -> ScenePack:
    return ScenePack(
        pos=_t(s.pos), normal=_t(s.normal), rgb=_t(s.rgb), pixel=_t(s.pixel),
        class_prob=_t(s.class_prob), edge_prob=_t(s.edge_prob),
        valid=_t(s.valid), centroid=_t(s.centroid),
        grid=neighbor_grid(s.grid), field=dense_field(s.field),
        icp_grid=neighbor_grid(s.icp_grid), edge_free=_t(s.edge_free),
        has_edge=bool(s.has_edge),
    )
