"""Dense PPF hash table: host build in numpy, device lookups in torch.

Counterpart of ``model_matching_tpu/ppf_table.py``. The model's point-pair
features are stored once per exact feature bin as a CSR layout (sorted
[P, 2] pair array + per-bin offset/count) behind an open-addressing int32
key table; the reference's 128-bin insertion fan-out is inverted into a
128-way query fan-out. Existence checks of base sampling hit a second
keys-only table of the fanned-out key set. When the model's dense key
space is small, direct-mapped twins of both tables turn a lookup into one
gather.

The build is the JAX package's: the all-pairs keys and the fan-out keys
come from the host C++ helpers (native.py) when they build, from the numpy
paths otherwise. It returns torch tensors on the CPU, which ``PPFTable.to``
moves to a device. ``resize_table`` rebuilds a table's layouts in torch on
the device the table is on.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np
import torch

from . import native
from .utils import trace
from .ops.ppf import MIN_DISTANCE_BIN_MM, _ANGLE_RADIX, fanout_deltas

# The direct-mapped tables are built only when the dense key space fits in
# this many entries (8 bytes per entry).
DIRECT_CAP = 1 << 23

_M32 = 0xFFFFFFFF


def _dense_radix(rot_disc: int) -> int:
    """Digit radix of the dense key packing of the direct-mapped tables:
    one more than the largest angle quotient (snapped angles reach 180)."""
    return 180 // rot_disc + 1


def dense_index_np(keys: np.ndarray, rot_disc: int, size: int) -> np.ndarray:
    """Radix-64 packed key -> dense direct-table index, -1 when out of
    range (a digit >= the dense radix was never inserted)."""
    ar = _dense_radix(rot_disc)
    a3 = keys & 63
    a2 = (keys >> 6) & 63
    a1 = (keys >> 12) & 63
    dq = (keys >> 18).astype(np.int64)
    ok = (keys >= 0) & (a1 < ar) & (a2 < ar) & (a3 < ar)
    idx = ((dq * ar + a1) * ar + a2) * ar + a3
    ok &= idx < size
    return np.where(ok, idx, -1).astype(np.int64)


def dense_index(keys: torch.Tensor, rot_disc: int, size: int) -> torch.Tensor:
    """Device mirror of dense_index_np on int32 keys."""
    ar = _dense_radix(rot_disc)
    a3 = keys & 63
    a2 = (keys >> 6) & 63
    a1 = (keys >> 12) & 63
    dq = keys >> 18
    ok = (keys >= 0) & (a1 < ar) & (a2 < ar) & (a3 < ar)
    idx = ((dq * ar + a1) * ar + a2) * ar + a3
    ok = ok & (idx < size)
    return torch.where(ok, idx, -1).to(torch.int32)


def _build_direct_np(
    uniq_keys: np.ndarray,
    offsets: np.ndarray,
    counts: np.ndarray,
    fan_keys: np.ndarray,
    rot_disc: int,
    min_size: int = 0,
    cap: int = DIRECT_CAP,
):
    """Direct-mapped twins of the two hash tables: bin_direct [S, 2] int32
    (offset, count) at the dense key index (count 0 == miss) and
    exist_direct [S/32] uint32, the membership bitmap of the fanned-out
    keys. Returns (None, None) when S would exceed `cap`."""
    ar = _dense_radix(rot_disc)
    if ar > 64:
        return None, None
    kmax = -1
    for k in (uniq_keys, fan_keys):
        if k.size:
            kmax = max(kmax, int(dense_index_np(k, rot_disc, 1 << 62).max()))
    if kmax < 0:
        return None, None
    size = 1 << int(np.ceil(np.log2(max(kmax + 1, 32))))
    size = max(size, min_size)
    if size > cap:
        return None, None
    bin_direct = np.zeros((size, 2), np.int32)
    bidx = dense_index_np(uniq_keys, rot_disc, size)
    good = bidx >= 0
    bin_direct[bidx[good], 0] = offsets[good].astype(np.int32)
    bin_direct[bidx[good], 1] = counts[good].astype(np.int32)
    exist_direct = np.zeros(size // 32, np.uint32)
    eidx = dense_index_np(fan_keys, rot_disc, size)
    eidx = eidx[eidx >= 0]
    np.bitwise_or.at(
        exist_direct, eidx >> 5, np.uint32(1) << (eidx & 31).astype(np.uint32)
    )
    return bin_direct, exist_direct


def _mix32_np(key: np.ndarray) -> np.ndarray:
    """murmur3 finalizer, a full-avalanche 32-bit mixer (bit-identical to
    _mix32)."""
    h = key.astype(np.uint32)
    with np.errstate(over="ignore"):
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


def _mix32(key: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 tensors holding uint32 values (int32
    inputs are reinterpreted as uint32); returns int64 uint32 values."""
    h = key.to(torch.int64) & _M32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def pack_exact_np(bins: np.ndarray, tr_disc: int, rot_disc: int) -> np.ndarray:
    """Pack exact feature bins [..., 4] -> int32 keys; -1 if out of range."""
    q = np.empty(bins.shape, dtype=np.int64)
    q[..., 0] = bins[..., 0] // tr_disc
    q[..., 1:] = bins[..., 1:] // rot_disc
    key = (
        (q[..., 0] * _ANGLE_RADIX + q[..., 1]) * _ANGLE_RADIX + q[..., 2]
    ) * _ANGLE_RADIX + q[..., 3]
    bad = (
        (bins < 0).any(axis=-1)
        | (q[..., 1:] >= _ANGLE_RADIX).any(axis=-1)
        | (key > np.iinfo(np.int32).max)
    )
    return np.where(bad, -1, key).astype(np.int32)


def pack_query_np(bins: np.ndarray, tr_disc: int, rot_disc: int) -> np.ndarray:
    """pack_exact_np with the insert-side rejection (a distance bin <= 5 mm
    or a negative angle never enters the map), so gated queries miss."""
    key = pack_exact_np(bins, tr_disc, rot_disc)
    bad = (bins[..., 0] <= MIN_DISTANCE_BIN_MM) | (bins < 0).any(axis=-1)
    return np.where(bad, -1, key).astype(np.int32)


def unpack_key_np(keys: np.ndarray, tr_disc: int, rot_disc: int) -> np.ndarray:
    """Packed keys -> their exact bins [..., 4] int32."""
    k = keys.astype(np.int64)
    q4 = k % _ANGLE_RADIX
    k //= _ANGLE_RADIX
    q3 = k % _ANGLE_RADIX
    k //= _ANGLE_RADIX
    q2 = k % _ANGLE_RADIX
    q1 = k // _ANGLE_RADIX
    return np.stack(
        [q1 * tr_disc, q2 * rot_disc, q3 * rot_disc, q4 * rot_disc], axis=-1
    ).astype(np.int32)


def fanout_keys(uniq_keys: np.ndarray, tr_disc: int, rot_disc: int
                ) -> np.ndarray:
    """[U*128] packed fan-out keys (-1 where the insert-side rejection
    applies) of the existence-set build; the deltas act in quotient space.
    The C++ helper when it is built, else numpy (the same keys)."""
    deltas = fanout_deltas(tr_disc, rot_disc)
    out = native.fanout_pack(uniq_keys, tr_disc, MIN_DISTANCE_BIN_MM, deltas)
    if out is not None:
        return out
    k = uniq_keys.astype(np.int64)
    q = np.empty((k.shape[0], 4), np.int32)
    q[:, 3] = k % _ANGLE_RADIX
    k //= _ANGLE_RADIX
    q[:, 2] = k % _ANGLE_RADIX
    k //= _ANGLE_RADIX
    q[:, 1] = k % _ANGLE_RADIX
    q[:, 0] = k // _ANGLE_RADIX
    nq = q[:, None, :] + deltas[None, :, :]          # [U, 128, 4] int32
    key = (
        (nq[..., 0].astype(np.int64) * _ANGLE_RADIX + nq[..., 1])
        * _ANGLE_RADIX + nq[..., 2]
    ) * _ANGLE_RADIX + nq[..., 3]
    bad = (
        (nq[..., 0] * tr_disc <= MIN_DISTANCE_BIN_MM)
        | (nq[..., 1:] < 0).any(axis=-1)
        | (nq[..., 1:] >= _ANGLE_RADIX).any(axis=-1)
        | (key > np.iinfo(np.int32).max)
    )
    return np.where(bad, -1, key).astype(np.int32).reshape(-1)


def _build_open_table(
    keys: np.ndarray, min_size: int = 0, oversize: int = 4
) -> Tuple[np.ndarray, int]:
    """Insert sorted unique int32 keys into a power-of-two linear-probe
    table of at least oversize * len(keys) slots. Returns (table of indices
    into `keys`, -1 = empty; a max_probes bound valid for hits and misses)."""
    u = keys.shape[0]
    size = 1 << int(np.ceil(np.log2(max(oversize * u, 16, min_size))))
    mask = np.uint32(size - 1)
    table = np.full(size, -1, dtype=np.int64)
    slot = (_mix32_np(keys) & mask).astype(np.int64)
    remaining = np.arange(u, dtype=np.int64)
    rounds = 0
    while remaining.size:
        s = slot[remaining]
        open_mask = table[s] == -1
        cand = remaining[open_mask]
        cand_slots = s[open_mask]
        uniq_slots, first = np.unique(cand_slots, return_index=True)
        table[uniq_slots] = cand[first]
        placed = np.zeros(u, dtype=bool)
        placed[cand[first]] = True
        remaining = remaining[~placed[remaining]]
        slot[remaining] = (slot[remaining] + 1) & int(mask)
        rounds += 1
        if rounds > size:
            raise RuntimeError("open addressing failed to converge")

    # a missing key scans until the first empty slot: the miss bound is the
    # longest circular run of occupied slots + 1
    occ = table != -1
    if occ.all():
        raise RuntimeError("hash table is full")
    first_empty = int(np.argmin(occ))
    occ_rot = np.roll(occ, -first_empty)
    padded = np.concatenate([[False], occ_rot, [False]])
    edges = np.flatnonzero(np.diff(padded.astype(np.int8)))
    longest_run = int((edges[1::2] - edges[0::2]).max()) if edges.size else 0
    return table, max(rounds, longest_run + 1)


@dataclasses.dataclass
class PPFTable:
    """Device-resident PPF map (see the module docstring for the layout)."""

    exist_keys: torch.Tensor   # [Te] int32, -1 = empty
    bin_keys: torch.Tensor     # [Tb] int32, -1 = empty
    bin_offset: torch.Tensor   # [Tb] int32
    bin_count: torch.Tensor    # [Tb] int32
    pairs: torch.Tensor        # [P, 2] int32, sorted by exact bin
    tr_disc: int
    rot_disc: int
    exist_max_probes: int
    bin_max_probes: int
    bin_direct: Optional[torch.Tensor] = None    # [S, 2] int32
    exist_direct: Optional[torch.Tensor] = None  # [S/32] int64 (uint32 words)

    @property
    def num_pairs(self) -> int:
        return self.pairs.shape[0]

    def to(self, device) -> "PPFTable":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


def _features_chunked(pos: np.ndarray, normal: np.ndarray, tr_disc: int,
                      rot_disc: int, chunk: int = 256):
    """Exact PPF bins for all ordered pairs, chunked over the first point.

    Yields (i0, bins [c, M, 4] int32, dist [c, M] f32)."""
    m = pos.shape[0]
    for i0 in range(0, m, chunk):
        p1 = pos[i0 : i0 + chunk, None, :]
        n1 = normal[i0 : i0 + chunk, None, :]
        p2 = pos[None, :, :]
        n2 = normal[None, :, :]
        u = p1 - p2
        d = np.linalg.norm(u, axis=-1)

        def angle(a, b):
            shape = np.broadcast_shapes(a.shape, b.shape)
            cr = np.cross(np.broadcast_to(a, shape), np.broadcast_to(b, shape))
            s = np.linalg.norm(cr, axis=-1)
            c = np.sum(a * b, axis=-1)
            return np.degrees(np.arctan2(s, c))

        f = np.empty(d.shape + (4,), dtype=np.int32)
        f[..., 0] = (d * 1000.0).astype(np.int32)
        f[..., 1] = angle(n1, u).astype(np.int32)
        f[..., 2] = angle(n2, u).astype(np.int32)
        f[..., 3] = angle(n1, n2).astype(np.int32)

        def snap(v, disc):
            lower = v - v % disc
            upper = lower + disc
            return np.where(v - lower < upper - v, lower, upper)

        bins = np.empty_like(f)
        bins[..., 0] = snap(f[..., 0], tr_disc)
        bins[..., 1:] = snap(f[..., 1:], rot_disc)
        yield i0, bins, d


def build_ppf_table(pos: np.ndarray, normal: np.ndarray, tr_disc: int,
                    rot_disc: int) -> Tuple[PPFTable, float]:
    """Offline O(M^2) build over all ordered pairs. Returns (table on the
    CPU, max pairwise distance)."""
    if rot_disc < 4:
        raise ValueError(
            f"ppf_rot_discretization must be >= 4 (got {rot_disc}): the "
            f"packed angle radix of 64 would alias keys"
        )
    if tr_disc < 1:
        raise ValueError(f"ppf_tr_discretization must be >= 1 (got {tr_disc})")
    m = pos.shape[0]
    pos = np.asarray(pos, dtype=np.float32)
    normal = np.asarray(normal, dtype=np.float32)

    native_out = native.ppf_pair_keys(pos, normal, tr_disc, rot_disc)
    if native_out is not None:
        all_keys, max_distance = native_out
    else:
        all_keys = np.empty((m, m), dtype=np.int32)
        max_distance = 0.0
        for i0, bins, d in _features_chunked(pos, normal, tr_disc, rot_disc):
            all_keys[i0 : i0 + bins.shape[0]] = pack_exact_np(bins, tr_disc, rot_disc)
            if d.size:
                max_distance = max(max_distance, float(d.max()))

    ii, jj = np.meshgrid(
        np.arange(m, dtype=np.int32), np.arange(m, dtype=np.int32), indexing="ij"
    )
    flat_keys = all_keys.reshape(-1)
    flat_pairs = np.stack([ii.reshape(-1), jj.reshape(-1)], axis=1)
    keep = (ii.reshape(-1) != jj.reshape(-1)) & (flat_keys >= 0)
    flat_keys = flat_keys[keep]
    flat_pairs = flat_pairs[keep]

    order = np.argsort(flat_keys, kind="stable")
    flat_keys = flat_keys[order]
    flat_pairs = flat_pairs[order]

    uniq_keys, offsets, counts = np.unique(
        flat_keys, return_index=True, return_counts=True
    )

    bin_table_idx, bin_probes = _build_open_table(uniq_keys, oversize=16)
    tb = bin_table_idx.shape[0]
    bin_keys = np.full(tb, -1, dtype=np.int32)
    bin_offset = np.zeros(tb, dtype=np.int32)
    bin_count = np.zeros(tb, dtype=np.int32)
    occ = bin_table_idx >= 0
    bin_keys[occ] = uniq_keys[bin_table_idx[occ]]
    bin_offset[occ] = offsets[bin_table_idx[occ]].astype(np.int32)
    bin_count[occ] = counts[bin_table_idx[occ]].astype(np.int32)

    # existence set: each exact bin fanned out by the 128 insertion deltas,
    # insert-side rejection applied, deduplicated
    fan_keys = fanout_keys(uniq_keys, tr_disc, rot_disc)
    fan_keys = np.unique(fan_keys[fan_keys >= 0])

    exist_table_idx, exist_probes = _build_open_table(fan_keys, oversize=8)
    te = exist_table_idx.shape[0]
    exist_keys = np.full(te, -1, dtype=np.int32)
    eocc = exist_table_idx >= 0
    exist_keys[eocc] = fan_keys[exist_table_idx[eocc]]

    bin_direct, exist_direct = _build_direct_np(
        uniq_keys, offsets, counts, fan_keys, rot_disc
    )
    table = PPFTable(
        exist_keys=torch.from_numpy(exist_keys),
        bin_keys=torch.from_numpy(bin_keys),
        bin_offset=torch.from_numpy(bin_offset),
        bin_count=torch.from_numpy(bin_count),
        pairs=torch.from_numpy(flat_pairs.astype(np.int32)),
        tr_disc=int(tr_disc),
        rot_disc=int(rot_disc),
        exist_max_probes=int(exist_probes),
        bin_max_probes=int(bin_probes),
        bin_direct=None if bin_direct is None else torch.from_numpy(bin_direct),
        exist_direct=(
            None if exist_direct is None
            else torch.from_numpy(exist_direct.astype(np.int64))
        ),
    )
    return table, max_distance


def _table_from_arrays(exist_keys, bin_keys, bin_offset, bin_count, pairs,
                       tr_disc, rot_disc, exist_max_probes, bin_max_probes,
                       bin_direct, exist_direct) -> PPFTable:
    """A CPU PPFTable from numpy arrays (uint32 bitmap words widen to
    int64)."""
    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a))

    return PPFTable(
        exist_keys=t(exist_keys.astype(np.int32)), bin_keys=t(bin_keys.astype(np.int32)),
        bin_offset=t(bin_offset.astype(np.int32)), bin_count=t(bin_count.astype(np.int32)),
        pairs=t(pairs.astype(np.int32)), tr_disc=int(tr_disc), rot_disc=int(rot_disc),
        exist_max_probes=int(exist_max_probes), bin_max_probes=int(bin_max_probes),
        bin_direct=t(bin_direct),
        exist_direct=None if exist_direct is None else t(exist_direct.astype(np.int64)),
    )


def _direct_from_tables(
    bin_keys: np.ndarray,
    bin_offset: np.ndarray,
    bin_count: np.ndarray,
    exist_keys: np.ndarray,
    rot_disc: int,
    min_size: int = 0,
):
    """Rebuild the direct-mapped twins from the persisted open-addressing
    content (the npz format carries only the probing tables)."""
    occ = bin_keys >= 0
    eocc = exist_keys >= 0
    return _build_direct_np(
        bin_keys[occ], bin_offset[occ], bin_count[occ],
        exist_keys[eocc], rot_disc, min_size=min_size,
    )


def _build_direct(bin_keys: torch.Tensor, offsets: torch.Tensor,
                  counts: torch.Tensor, exist_keys: torch.Tensor, rot_disc: int,
                  size: int):
    """_build_direct_np's twins at `size` entries in torch on the keys'
    device, from unique keys: bin_direct [S, 2] int32 and exist_direct
    [S/32] int64 (uint32 words). Keys outside the dense space land in a
    dropped last row / word."""
    bidx = dense_index(bin_keys, rot_disc, size).long()
    bin_direct = bin_keys.new_zeros((size + 1, 2))
    bin_direct[torch.where(bidx >= 0, bidx, size)] = torch.stack([offsets, counts], 1)
    eidx = dense_index(exist_keys, rot_disc, size).long()
    words = torch.where(eidx >= 0, eidx >> 5, size // 32)
    # the dense index is injective on unique keys, so the bits of a word
    # are distinct and their sum is numpy's bitwise_or.at
    exist_direct = eidx.new_zeros(size // 32 + 1).index_add_(
        0, words, torch.where(eidx >= 0, 1 << (eidx & 31), 0))
    return bin_direct[:size], exist_direct[:size // 32]


def resize_table(
    table: PPFTable, exist_size: int, bin_size: int, num_pairs: int,
    direct_size: int | None = 0,
) -> PPFTable:
    """Rebuild a table's open-addressing layouts at the given power-of-two
    sizes and pad the pair array, so several models share identical shapes.
    The stored keys/CSR content is unchanged; `direct_size` None drops the
    direct-mapped twins. Built in torch on the table's device, equal bit
    for bit to the numpy build (`_build_open_table`, `_build_direct_np`).
    Host reads: the two key counts, then each table's state every
    `_TABLE_ROUNDS` insertion rounds (the first with the largest dense
    index); no array leaves the device. Counts `ppf_table.resizes`."""
    from .ops.gridhash import _open_table, _read

    trace.count("ppf_table.resizes")
    ex, bx = table.exist_keys, table.bin_keys
    n_exist, n_bin = _read((ex >= 0).sum(), (bx >= 0).sum())
    # sorted unique keys: the empty slots (-1) sort first
    ek = torch.sort(ex).values[ex.shape[0] - n_exist:]
    bk, order = (t[bx.shape[0] - n_bin:] for t in torch.sort(bx))
    # the largest dense index of either key set (an empty slot gives -1)
    no_cap = torch.iinfo(torch.int32).max
    kmax = torch.maximum(dense_index(ex, table.rot_disc, no_cap).max(),
                         dense_index(bx, table.rot_disc, no_cap).max())
    et_idx, e_probes, (kmax,) = _open_table(ek, (kmax,), min_size=exist_size)
    bt_idx, b_probes, _ = _open_table(bk, min_size=bin_size)

    def fill(idx, values, empty):
        return torch.where(idx >= 0, values[torch.clamp(idx, min=0)], empty)

    bo, bc = table.bin_offset[order], table.bin_count[order]
    pairs = table.pairs
    if pairs.shape[0] < num_pairs:
        pairs = torch.cat([pairs, pairs.new_zeros((num_pairs - pairs.shape[0], 2))])

    bin_direct = exist_direct = None
    if direct_size is not None and _dense_radix(table.rot_disc) <= 64 and kmax >= 0:
        size = max(1 << int(np.ceil(np.log2(max(kmax + 1, 32)))), direct_size)
        if size <= DIRECT_CAP:
            bin_direct, exist_direct = _build_direct(bk, bo, bc, ek, table.rot_disc, size)
    return PPFTable(
        exist_keys=fill(et_idx, ek, -1), bin_keys=fill(bt_idx, bk, -1),
        bin_offset=fill(bt_idx, bo, 0), bin_count=fill(bt_idx, bc, 0), pairs=pairs,
        tr_disc=table.tr_disc, rot_disc=table.rot_disc,
        exist_max_probes=int(e_probes), bin_max_probes=int(b_probes),
        bin_direct=bin_direct, exist_direct=exist_direct,
    )


# ---------------------------------------------------------------------------
# persistence: the JAX package's .npz format (each package reads the
# other's files)
# ---------------------------------------------------------------------------

FORMAT_VERSION = 1


def save_ppf_table(path: str, table: PPFTable, extra_meta: dict | None = None):
    meta = {
        "format_version": FORMAT_VERSION,
        "tr_disc": table.tr_disc,
        "rot_disc": table.rot_disc,
        "exist_max_probes": table.exist_max_probes,
        "bin_max_probes": table.bin_max_probes,
    }
    if extra_meta:
        meta.update(extra_meta)
    trace.count("host_reads", 5)
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        exist_keys=table.exist_keys.cpu().numpy(),
        bin_keys=table.bin_keys.cpu().numpy(),
        bin_offset=table.bin_offset.cpu().numpy(),
        bin_count=table.bin_count.cpu().numpy(),
        pairs=table.pairs.cpu().numpy(),
    )


def load_ppf_table(path: str) -> Tuple[PPFTable, dict]:
    """(table on the CPU, metadata) from a .npz written by either package."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported ppf table version {meta.get('format_version')}"
            )
        arrays = {k: z[k] for k in ("exist_keys", "bin_keys", "bin_offset",
                                    "bin_count", "pairs")}
    bin_direct, exist_direct = _direct_from_tables(
        arrays["bin_keys"], arrays["bin_offset"], arrays["bin_count"],
        arrays["exist_keys"], int(meta["rot_disc"]),
    )
    table = _table_from_arrays(
        arrays["exist_keys"], arrays["bin_keys"], arrays["bin_offset"],
        arrays["bin_count"], arrays["pairs"], meta["tr_disc"], meta["rot_disc"],
        meta["exist_max_probes"], meta["bin_max_probes"], bin_direct, exist_direct)
    return table, meta


# ---------------------------------------------------------------------------
# device-side lookups
# ---------------------------------------------------------------------------

def probe_slots(table_keys: torch.Tensor, keys: torch.Tensor,
                max_probes: int) -> torch.Tensor:
    """Bounded linear probing, a fixed `max_probes` sweeps (no host read of
    an all-done flag). keys int32 [...]; returns the slot per key, or -1 on
    a miss (keys of -1 always miss)."""
    size = table_keys.shape[0]
    h0 = _mix32(keys) & (size - 1)
    slot = torch.full(keys.shape, -1, dtype=torch.int64, device=keys.device)
    done = keys < 0
    for i in range(max_probes):
        h = (h0 + i) & (size - 1)
        k = table_keys[h]
        found = (k == keys) & ~done
        slot = torch.where(found, h, slot)
        done = done | found | (k == -1)
    return slot


def ppf_exists(table: PPFTable, keys: torch.Tensor) -> torch.Tensor:
    """Existence check of packed keys (the hot lookup of base sampling):
    one bitmap word gather + bit test when the direct table exists."""
    if table.exist_direct is not None:
        nbits = table.exist_direct.shape[0] * 32
        didx = dense_index(keys, table.rot_disc, nbits)
        word = table.exist_direct[torch.clamp(didx >> 5, min=0).long()]
        bit = (word >> (didx & 31).long()) & 1
        return (didx >= 0) & (bit == 1)
    return probe_slots(table.exist_keys, keys, table.exist_max_probes) >= 0


def lookup_pair_range(table: PPFTable, query_bins: torch.Tensor):
    """Offsets/counts of all exact bins matching query bins [..., 4] via the
    128-way inverse fan-out. Returns (offset [..., 128], count [..., 128])
    int32, count 0 for misses; the concatenated CSR ranges are the
    reference's pair list for that bin (ranges are disjoint)."""
    dev = query_bins.device
    deltas = torch.from_numpy(fanout_deltas(table.tr_disc, table.rot_disc)).to(dev)
    scale = torch.tensor(
        [table.tr_disc, table.rot_disc, table.rot_disc, table.rot_disc],
        dtype=torch.int32, device=dev,
    )
    src_bins = query_bins[..., None, :] - deltas * scale    # [..., 128, 4]
    q1 = torch.div(src_bins[..., 0], table.tr_disc, rounding_mode="floor")
    qr = torch.div(src_bins[..., 1:], table.rot_disc, rounding_mode="floor")
    key = ((q1 * _ANGLE_RADIX + qr[..., 0]) * _ANGLE_RADIX
           + qr[..., 1]) * _ANGLE_RADIX + qr[..., 2]
    src_ok = (src_bins >= 0).all(dim=-1) & (qr < _ANGLE_RADIX).all(dim=-1)
    # query-side gate: bins the reference never inserted have no entries
    gate = (query_bins[..., 0] > MIN_DISTANCE_BIN_MM) & (query_bins >= 0).all(-1)
    keys = torch.where(src_ok & gate[..., None], key, -1).to(torch.int32)

    if table.bin_direct is not None:
        didx = dense_index(keys, table.rot_disc, table.bin_direct.shape[0])
        row = table.bin_direct[torch.clamp(didx, min=0).long()]
        hit = didx >= 0
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return (torch.where(hit, row[..., 0], zero),
                torch.where(hit, row[..., 1], zero))

    slots = probe_slots(table.bin_keys, keys, table.bin_max_probes)
    hit = slots >= 0
    safe = torch.clamp(slots, min=0)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return (torch.where(hit, table.bin_offset[safe], zero),
            torch.where(hit, table.bin_count[safe], zero))


def gather_pair_srcs(table: PPFTable, offset: torch.Tensor,
                     count: torch.Tensor, cap: int):
    """Flatten the <=128 CSR ranges of each row of offset/count [..., R]
    into padded [..., cap] source positions into table.pairs + a validity
    mask + the total pair count. Overflow beyond `cap` is truncated."""
    total_before = torch.cumsum(count, -1, dtype=torch.int32) - count
    total = count.sum(-1, dtype=torch.int32)
    s = torch.arange(cap, dtype=torch.int32, device=offset.device)
    ends = total_before + count
    # range index of slot s: the number of ranges ending at or before s
    r_idx = torch.searchsorted(ends.contiguous(), s.expand(
        ends.shape[:-1] + (cap,)).contiguous(), right=True)
    r_idx = torch.clamp(r_idx, max=count.shape[-1] - 1)
    within = s - torch.gather(total_before, -1, r_idx)
    valid = s < total[..., None]
    src = torch.gather(offset, -1, r_idx) + within
    src = torch.clamp(src, 0, table.pairs.shape[0] - 1)
    return src, valid, total


def gather_pairs(table: PPFTable, offset: torch.Tensor, count: torch.Tensor,
                 cap: int):
    """gather_pair_srcs and the [..., cap, 2] pair-index gather."""
    src, valid, total = gather_pair_srcs(table, offset, count, cap)
    return table.pairs[src.long()], valid, total


def gather_pair_block_srcs(table: PPFTable, offset: torch.Tensor,
                           count: torch.Tensor, cap: int, block: int = 4,
                           slack: int = 128):
    """Block-granular gather_pair_srcs: the CSR ranges flattened into
    `block`-pair-aligned block positions, so a caller reading rows from a
    [P/block, block*6] view issues one row read per `block` pairs.

    Returns (bsrc [..., capb] block indices, lane_ok [..., capb, block],
    total pairs) with capb = cap // block + slack. A block shared by two
    adjacent ranges appears once per range with disjoint lane masks."""
    capb = cap // block + slack
    bstart = torch.div(offset, block, rounding_mode="floor")
    bcnt = torch.where(
        count > 0,
        torch.div(offset + count + block - 1, block, rounding_mode="floor")
        - bstart,
        0,
    ).to(torch.int32)
    cumb = torch.cumsum(bcnt, -1, dtype=torch.int32) - bcnt
    ends = cumb + bcnt
    t = torch.arange(capb, dtype=torch.int32, device=offset.device)
    r_idx = torch.searchsorted(ends.contiguous(), t.expand(
        ends.shape[:-1] + (capb,)).contiguous(), right=True)
    r_idx = torch.clamp(r_idx, max=count.shape[-1] - 1)
    g = torch.gather(bstart, -1, r_idx) + (t - torch.gather(cumb, -1, r_idx))
    bvalid = t < bcnt.sum(-1, dtype=torch.int32)[..., None]
    pair_lo = torch.gather(offset, -1, r_idx)
    pair_hi = pair_lo + torch.gather(count, -1, r_idx)
    lanes = g[..., None] * block + torch.arange(
        block, dtype=torch.int32, device=offset.device)
    lane_ok = (
        bvalid[..., None]
        & (lanes >= pair_lo[..., None])
        & (lanes < pair_hi[..., None])
    )
    max_block = (table.pairs.shape[0] + block - 1) // block
    bsrc = torch.clamp(g, 0, max_block - 1)
    return bsrc, lane_ok, count.sum(-1, dtype=torch.int32)
