"""Dense nearest-neighbor field for the fast scoring path.

Counterpart of ``model_matching_tpu/ops/densefield.py``. For every cell of a
dense eps-grid over the scene bbox the build stores the scene point nearest
to the cell center within eps * (1 + sqrt(3)/2); a query reads its cell's
row (position, normal, index, weight) and applies the exact distance and
normal gates to that stored candidate. Built and read in torch on the
device of the points (the build equal bit for bit to the JAX package's
numpy build); the row read is the row-gather kernel (ops/row_gather.py) on
the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fp import div_const, f32, norm3
from .gridhash import _NONE, _as_f32, _cell_bounds, _read
from .row_gather import row_gather

_SLACK = 1.0 + np.sqrt(3.0) / 2.0


@dataclasses.dataclass
class DenseField:
    rows: torch.Tensor    # [G, 8] f32: px py pz nx ny nz idx occupancy/prob
    origin: torch.Tensor  # [3]
    dims: torch.Tensor    # [3] i32
    cell: torch.Tensor    # [] f32 (= eps)
    # slot 7: occupancy flag (1/0) without baked probs; with them the
    # candidate's class probability (>= 0) and -1 for empty cells
    has_probs: bool = False

    def to(self, device) -> "DenseField":
        return dataclasses.replace(
            self, rows=self.rows.to(device), origin=self.origin.to(device),
            dims=self.dims.to(device), cell=self.cell.to(device),
        )


def build_dense_field(pos, normal, eps: float, prob=None) -> DenseField:
    """Build from unpadded [N, 3] positions and normals on their device
    (tensors, or numpy arrays: then on the CPU), equal bit for bit to the
    numpy build of the JAX package's ops/densefield.py. One host read: the
    dims."""
    eps = float(eps)
    pos = _as_f32(pos)
    dev = pos.device
    normal = _as_f32(normal, dev)
    n = pos.shape[0]
    lo, dims_t, stride = _cell_bounds(pos, 2 * eps, eps)
    (dims,) = _read(dims_t)
    g = int(np.prod(dims))

    # candidate (cell, point) pairs: each point covers the cells whose
    # center lies within SLACK * eps
    reach = int(np.ceil(_SLACK))
    step = torch.arange(-reach, reach + 1, device=dev)
    offs = torch.cartesian_prod(step, step, step)
    pc = torch.floor(div_const(pos - lo, eps)).to(torch.int64)
    cells = pc[:, None, :] + offs
    centers = (cells.to(torch.float32) + 0.5) * f32(eps) + lo
    d = norm3(centers - pos[:, None, :])
    ok = (d.double() <= float(_SLACK * eps)) & ((cells >= 0) & (cells < dims_t)).all(-1)

    # per cell the candidate nearest to its center, ties to the lowest point
    # index: the least of (float32 bits of the distance, >= 0) << 32 | point
    key = (d.view(torch.int32).to(torch.int64) << 32) | torch.arange(n, device=dev)[:, None]
    cell = torch.where(ok, (cells * stride).sum(-1), g)
    best = torch.full((g + 1,), _NONE, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, cell.flatten(), torch.where(ok, key, _NONE).flatten(), "amin")
    hit = best[:g, None] != _NONE
    win = torch.where(hit[:, 0], best[:g] & 0xFFFFFFFF, 0)

    s7 = (torch.ones(n, device=dev) if prob is None else _as_f32(prob, dev))
    rows = torch.cat([pos, normal, torch.arange(n, device=dev).to(torch.float32)[:, None],
                      s7[:, None]], 1)[win]
    rows = torch.where(hit, rows, 0.0)
    if prob is not None:
        rows[:, 7].masked_fill_(~hit[:, 0], -1.0)
    return DenseField(
        rows=rows,
        origin=lo,
        dims=dims_t.to(torch.int32),
        cell=torch.full((), f32(eps), dtype=torch.float32, device=dev),
        has_probs=prob is not None,
    )


def field_lookup(field: DenseField, points: torch.Tensor):
    """[..., 3] query positions -> (cand_pos [..., 3], cand_normal [..., 3],
    cand_idx [...] i32, occupied [...] bool, slot7 [...] f32)."""
    ijk = torch.floor((points - field.origin) / field.cell).to(torch.int32)
    inb = ((ijk >= 0) & (ijk < field.dims)).all(dim=-1)
    flat = (ijk[..., 0] * field.dims[1] + ijk[..., 1]) * field.dims[2] + ijk[..., 2]
    flat = torch.clamp(flat, 0, field.rows.shape[0] - 1)
    row = row_gather(field.rows, flat)
    s7 = row[..., 7]
    occupied = inb & ((s7 >= 0) if field.has_probs else (s7 > 0))
    return row[..., 0:3], row[..., 3:6], row[..., 6].to(torch.int32), occupied, s7
