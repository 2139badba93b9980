"""Voxel-grid spatial hash for restricted nearest-neighbor queries.

Counterpart of ``model_matching_tpu/ops/gridhash.py``. The scene is binned
into cells of the query radius; every cell of the dilated occupied set
stores the candidate list of its 3x3x3 neighborhood (ball-filtered). A
query is one hash probe plus a fixed-cap scan, or, with the padded-payload
layout, one cell-map read plus one [cell_cap, 8] row read. Built and
queried in torch on the device of the points, equal bit for bit to the
JAX package's numpy build.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ppf_table import _mix32
from .fp import div_const, f32, norm3
from .row_gather import row_gather


@dataclasses.dataclass
class NeighborGrid:
    origin: torch.Tensor        # [3] f32 — grid corner (min - 1 cell)
    dims: torch.Tensor          # [3] i32 — cells per axis
    cell_size: torch.Tensor     # [] f32
    table_keys: torch.Tensor    # [T] i32 open addressing (-1 empty)
    table_offset: torch.Tensor  # [T] i32 into cand_idx
    table_count: torch.Tensor   # [T] i32
    cand_idx: torch.Tensor      # [C] i32 point indices
    max_probes: int
    cell_cap: int
    # padded-payload fast path: dense cell -> row map plus one
    # [cell_cap, 8] f32 row per dilated cell (px py pz nx ny nz idx w);
    # None when over the memory guards
    cell_map: Optional[torch.Tensor] = None   # [prod(dims)] i32, -1 = empty
    payload: Optional[torch.Tensor] = None    # [U, cell_cap, 8] f32
    has_normals: bool = False
    # slot 7 holds the candidate's class probability (only valid for the
    # undecayed vector the grid was built with), else 1.0
    has_probs: bool = False

    def to(self, device) -> "NeighborGrid":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


# candidates further than this many cell sizes from a cell center can never
# be the NN of a query in that cell when the query radius <= cell size
_BALL_SLACK = 1.0 + np.sqrt(3.0) / 2.0

# payload memory guards (the probe + scan path still answers exactly)
_MAX_MAP_CELLS = 1 << 26
_MAX_PAYLOAD_BYTES = 512 << 20

# open-addressing insertion rounds between two host reads of the table's state
_TABLE_ROUNDS = 8

_NONE = torch.iinfo(torch.int64).max


def _read(*tensors):
    """One counted host read of a group of integer device values; 0-dim
    values come back as ints, others as int64 arrays."""
    from ..estimator import _to_host

    return [int(v) if v.ndim == 0 else v.astype(np.int64) for v in _to_host(*tensors)]


def _as_f32(a, device=None) -> torch.Tensor:
    """`a` (a tensor, or a numpy array read in place) as float32 on
    `device` (default: where it is)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return a.to(device=device, dtype=torch.float32)


def _cell_bounds(pos: torch.Tensor, pad: float, cell: float):
    """Grid corner lo = min - pad [3] f32 and cells per axis dims =
    max(ceil((max + pad - lo) / cell) + 1, 1) [3] int64, rounded as numpy
    rounds them in float32; plus the strides [3] of the linear cell key
    (i * d1 + j) * d2 + k."""
    lo = pos.amin(0) - f32(pad)
    hi = pos.amax(0) + f32(pad)
    dims = torch.clamp(torch.ceil(div_const(hi - lo, cell)).to(torch.int64) + 1, min=1)
    stride = torch.stack([dims[1] * dims[2], dims[2], torch.ones_like(dims[2])])
    return lo, dims, stride


def _place(dest: torch.Tensor, values: torch.Tensor, count: int) -> torch.Tensor:
    """[count] with values[i] at dest[i]; entries with dest == count are
    dropped. `count` is already on the host, so nothing waits for the
    device."""
    return values.new_empty(count + 1).scatter_(0, dest, values)[:count]


def _open_table(keys: torch.Tensor, extra=(), min_size: int = 0):
    """ppf_table._build_open_table on the device of the sorted unique keys:
    the same power-of-two linear-probe table of at least 4 * len(keys), 16
    and `min_size` slots (indices into `keys`, -1 = empty) and max_probes.
    Each round every key still waiting probes its slot, and the
    lowest-indexed one takes an open slot, as np.unique(return_index=True)
    picks it there; a key placed in round r has moved r slots, so the
    rounds are the largest move + 1. The state is read every _TABLE_ROUNDS
    rounds, the first time together with the device values `extra`.
    Returns (table, max_probes, the values of `extra`)."""
    dev = keys.device
    u = keys.shape[0]
    size = 1 << int(np.ceil(np.log2(max(4 * u, 16, min_size))))
    mask = size - 1
    home = _mix32(keys) & mask
    slot = home
    idx = torch.arange(u, device=dev)
    table = torch.full((size,), u, dtype=torch.int64, device=dev)   # u = open
    at = torch.arange(size, device=dev)
    extra_values = None
    rounds = 0
    while True:
        rounds += _TABLE_ROUNDS
        for _ in range(_TABLE_ROUNDS):
            bid = torch.where(table[slot] == u, idx, u)
            table.scatter_reduce_(0, slot, bid, "amin")
            slot = (slot + (table[slot] != idx)) & mask
        # a missing key scans until the first empty slot: the miss bound is
        # the longest circular run of occupied slots + 1 (any empty slot
        # starts the circle)
        occ = table < u
        ring = occ[(at + torch.argmin(occ.to(torch.int32))) % size]
        run = at - torch.cummax(torch.where(ring, -1, at), 0).values
        waiting, moved, longest, full, *got = _read(
            (table[slot] != idx).any(), ((slot - home) & mask).max(), run.max(),
            occ.all(), *extra)
        if extra_values is None:
            extra, extra_values = (), got
        if full:
            raise RuntimeError("hash table is full")
        if not waiting:
            table = torch.where(occ, table, -1)
            return table, max(moved + 1, longest + 1), extra_values
        if rounds > size:
            raise RuntimeError("open addressing failed to converge")


def build_neighbor_grid(
    pos,
    cell_size: float,
    cell_cap: int | None = None,
    normal=None,
    prob=None,
    payload: bool = True,
) -> NeighborGrid:
    """Build from unpadded [N, 3] positions on their device (tensors, or
    numpy arrays: then on the CPU), equal bit for bit to the numpy build of
    the JAX package's ops/gridhash.py.

    cell_cap=None sizes the scan cap to the longest candidate list (exact);
    an explicit cap bounds memory and warns when it truncates. `normal` /
    `prob` bake per-candidate normals / class probabilities into the
    payload rows. Host reads: the dims and the dilated cell count, the
    candidate total, then the longest list with the table's state (one
    more every _TABLE_ROUNDS insertion rounds)."""
    cell_size = float(cell_size)
    pos = _as_f32(pos)
    dev = pos.device
    n = pos.shape[0]
    lo, dims_t, stride = _cell_bounds(pos, cell_size, cell_size)
    ijk = torch.floor(div_const(pos - lo, cell_size)).to(torch.int64)
    ijk = torch.minimum(torch.clamp(ijk, min=0), dims_t - 1)
    keys = (ijk * stride).sum(-1)

    # dilated cell set: every cell adjacent to an occupied cell, sorted
    step = torch.arange(-1, 2, device=dev)
    offsets = torch.cartesian_prod(step, step, step)     # [27, 3], dz fastest
    dilated = ijk[:, None, :] + offsets
    ok = ((dilated >= 0) & (dilated < dims_t)).all(-1)
    dk = torch.sort(torch.where(ok, (dilated * stride).sum(-1), _NONE).flatten()).values
    first = torch.ones_like(dk, dtype=torch.bool)
    first[1:] = dk[1:] != dk[:-1]
    first &= dk != _NONE
    dims, u = _read(dims_t, first.sum())
    dilated_keys = _place(torch.where(first, torch.cumsum(first, 0) - 1, u), dk, u)

    # each cell's 27 neighbour key ranges in the points sorted by key (the
    # stable sort keeps equal keys in point order), cell-major: the order
    # numpy's stable regroup by cell gives
    keys_sorted, order = torch.sort(keys, stable=True)
    nkeys = dilated_keys[:, None] + (offsets * stride).sum(-1)
    starts = torch.searchsorted(keys_sorted, nkeys).flatten()
    tt = torch.searchsorted(keys_sorted, nkeys, right=True).flatten() - starts
    (total,) = _read(tt.sum())
    seg = torch.repeat_interleave(torch.arange(u * 27, device=dev), tt, output_size=total)
    r = torch.arange(total, device=dev) - (torch.cumsum(tt, 0) - tt)[seg]
    cand_pt = order[starts[seg] + r]
    cell_for = seg // 27

    # ball filter against the owning cell's center
    cxyz = (dilated_keys[:, None] // stride) % dims_t
    centers = lo + (cxyz.to(torch.float32) + 0.5) * f32(cell_size)
    d = norm3(pos[cand_pt] - centers[cell_for])
    keep = d.double() <= float(_BALL_SLACK * cell_size * (1.0 + 1e-5))
    counts = torch.zeros(u, dtype=torch.int64, device=dev).index_add_(0, cell_for, keep.long())
    group_start = torch.cumsum(counts, 0) - counts
    within = torch.cumsum(keep, 0) - 1 - group_start[cell_for]

    cand_count = counts if cell_cap is None else torch.clamp(counts, max=cell_cap)
    table_idx, max_probes, (max_count, n_flat, dropped, over) = _open_table(
        dilated_keys, (counts.max(), cand_count.sum(), (counts - cand_count).sum(),
                       (counts > cand_count).sum()))
    if cell_cap is None:
        cap = max(8, -(-max_count // 8) * 8)
    else:
        cap = cell_cap
        if dropped:
            from ..utils.log import warn

            warn(
                f"neighbor grid dropped {dropped} candidate entries in "
                f"{over}/{u} cells — NN queries in "
                f"those cells may miss the true nearest point; raise "
                f"cell_cap or pass None for the exact auto cap",
                cell_cap=cap, densest=max_count,
            )

    cand_offset = torch.cumsum(cand_count, 0) - cand_count
    dest = torch.where(keep & (within < cap), cand_offset[cell_for] + within, n_flat)
    flat = _place(dest, cand_pt, n_flat)

    g_total = int(np.prod(dims))
    pay = cmap = None
    has_normals = False
    if (
        payload
        and u
        and n < (1 << 24)
        and g_total <= _MAX_MAP_CELLS
        and u * cap * 32 <= _MAX_PAYLOAD_BYTES
    ):
        rows_ = torch.repeat_interleave(torch.arange(u, device=dev), cand_count,
                                        output_size=n_flat)
        cols_ = torch.arange(n_flat, device=dev) - cand_offset[rows_]
        pay = torch.zeros((u, cap, 8), dtype=torch.float32, device=dev)
        pay[:, :, 0:3] = torch.inf               # pad positions never win
        pay[:, :, 6] = -1.0
        has_normals = normal is not None
        pay[rows_, cols_] = torch.cat([
            pos[flat],
            _as_f32(normal, dev)[flat] if has_normals else pos.new_zeros((n_flat, 3)),
            flat.to(torch.float32)[:, None],
            (pos.new_ones(n_flat) if prob is None else _as_f32(prob, dev)[flat])[:, None],
        ], 1)
        cmap = torch.full((g_total,), -1, dtype=torch.int32, device=dev)
        cmap[dilated_keys] = torch.arange(u, dtype=torch.int32, device=dev)

    occ = table_idx >= 0
    ti = torch.clamp(table_idx, min=0)
    return NeighborGrid(
        origin=lo,
        dims=dims_t.to(torch.int32),
        cell_size=torch.full((), f32(cell_size), dtype=torch.float32, device=dev),
        table_keys=torch.where(occ, dilated_keys[ti], -1).to(torch.int32),
        table_offset=torch.where(occ, cand_offset[ti], 0).to(torch.int32),
        table_count=torch.where(occ, cand_count[ti], 0).to(torch.int32),
        cand_idx=flat.to(torch.int32),
        max_probes=int(max_probes),
        cell_cap=int(cap),
        cell_map=cmap,
        payload=pay,
        has_normals=has_normals,
        has_probs=pay is not None and prob is not None,
    )


def _cell_of(grid: NeighborGrid, points: torch.Tensor):
    ijk = torch.floor((points - grid.origin) / grid.cell_size).to(torch.int32)
    in_grid = ((ijk >= 0) & (ijk < grid.dims)).all(dim=-1)
    flat = (ijk[..., 0] * grid.dims[1] + ijk[..., 1]) * grid.dims[2] + ijk[..., 2]
    return flat, in_grid


def _query_payload(grid: NeighborGrid, points: torch.Tensor, radius):
    """Fast-path restricted NN: one map read + one padded-row read per
    query, first-minimum tie-break. Returns (idx, sqdist, k, pay) where k /
    pay let callers read more of the winner's row."""
    flat, in_grid = _cell_of(grid, points)
    rid = grid.cell_map[torch.clamp(flat, 0, grid.cell_map.shape[0] - 1).long()]
    rid = torch.where(in_grid, rid, -1)
    u, cap, width = grid.payload.shape
    pay = row_gather(grid.payload.view(u, cap * width),
                     torch.clamp(rid, min=0)).view(rid.shape + (cap, width))
    diff = points[..., None, :] - pay[..., 0:3]
    sq = diff * diff
    d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]
    live = (rid >= 0)[..., None] & (pay[..., 6] >= 0)
    d2 = torch.where(live, d2, torch.inf)
    k = torch.argmin(d2, dim=-1)
    best_d2 = torch.gather(d2, -1, k[..., None])[..., 0]
    idx = torch.gather(pay[..., 6], -1, k[..., None])[..., 0]
    ok = best_d2 <= radius * radius
    return (
        torch.where(ok, idx.to(torch.int32), -1),
        torch.where(ok, best_d2, torch.inf),
        k,
        pay,
    )


def _payload_slot(pay, k, lo, hi):
    """Winner row slice pay[..., k, lo:hi]."""
    idx = k[..., None, None].expand(k.shape + (1, hi - lo))
    return torch.gather(pay[..., lo:hi], -2, idx)[..., 0, :]


def query_restricted_nn(grid: NeighborGrid, points: torch.Tensor,
                        target_pos: torch.Tensor, radius):
    """Nearest target index within `radius` per query (or -1), keeping
    sqdist <= radius^2. Returns (index [...], sqdist [...])."""
    if grid.payload is not None:
        idx, d2, _k, _pay = _query_payload(grid, points, radius)
        return idx, d2
    key, in_grid = _cell_of(grid, points)
    key = torch.where(in_grid, key, -1)
    tsize = grid.table_keys.shape[0]
    h0 = _mix32(key) & (tsize - 1)
    slot = torch.full(key.shape, -1, dtype=torch.int64, device=points.device)
    done = key < 0
    for i in range(grid.max_probes):
        h = (h0 + i) & (tsize - 1)
        k = grid.table_keys[h]
        found = (k == key) & ~done
        slot = torch.where(found, h, slot)
        done = done | found | (k == -1)
    hit = slot >= 0
    safe = torch.clamp(slot, min=0)
    off = torch.where(hit, grid.table_offset[safe], 0)
    cnt = torch.where(hit, grid.table_count[safe], 0)

    r2 = radius * radius
    best_d2 = torch.full(key.shape, torch.inf, dtype=points.dtype, device=points.device)
    best_idx = torch.full(key.shape, -1, dtype=torch.int32, device=points.device)
    for k in range(grid.cell_cap):
        live = k < cnt
        ci = grid.cand_idx[torch.clamp(off + k, 0, grid.cand_idx.shape[0] - 1).long()]
        diff = points - target_pos[ci.long()]
        sq = diff * diff
        d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]
        better = live & (d2 <= r2) & (d2 < best_d2)
        best_d2 = torch.where(better, d2, best_d2)
        best_idx = torch.where(better, ci, best_idx)
    return best_idx, best_d2


def query_restricted_nn_normal(grid: NeighborGrid, points: torch.Tensor,
                               target_pos: torch.Tensor,
                               target_normal: torch.Tensor, radius):
    """query_restricted_nn plus the winner's normal (from the payload row
    when baked; callers gate on idx >= 0 before using it)."""
    if grid.payload is not None and grid.has_normals:
        idx, d2, k, pay = _query_payload(grid, points, radius)
        return idx, d2, _payload_slot(pay, k, 3, 6)
    idx, d2 = query_restricted_nn(grid, points, target_pos, radius)
    return idx, d2, target_normal[torch.clamp(idx, min=0).long()]


def query_restricted_nn_scored(grid: NeighborGrid, points: torch.Tensor,
                               radius):
    """query_restricted_nn plus the winner's baked normal and class
    probability, entirely from the payload row."""
    if grid.payload is None or not (grid.has_normals and grid.has_probs):
        raise ValueError(
            "query_restricted_nn_scored needs a payload grid built with "
            "normal= and prob= (see build_neighbor_grid)"
        )
    idx, d2, k, pay = _query_payload(grid, points, radius)
    return idx, d2, _payload_slot(pay, k, 3, 6), _payload_slot(pay, k, 7, 8)[..., 0]
