"""The congruent-set dense gate: the CUDA kernel's wrapper and its plain
torch version.

Replaces ``model_matching_tpu/ops/pallas_congruent.py`` (``dense_gate``)
and the JAX package's XLA gate for the dense congruent tiers. For each
base of a batch it evaluates the [P, Q] gate between the base's two PPF
pair lists and reduces the packed (random | marker | column) keys of the
matches to a per-row maximum over `n_sub` (16 on the main path) contiguous
stripes of each Q tile, plus per-row match counts. The kernel is
``csrc/dense_gate.cu``; ``dense_gate_reference`` is the same function in
torch ops, with the same arithmetic order, so the two agree bit for bit.

Layout (chosen for the kernel; the TPU kernel's 16-bit cell halves are not
needed): per side a feature block [B, 8, N] f32 (rows 0-2 world position,
3-5 unit pair direction, 6 squared norm, 7 unused), int32 cell ids [B, N]
with distinct negative tags on invalid lanes (P side -1, Q side -2), and
int32 random streams [B, N].
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from . import _build

SUB = 16       # most stripes per Q tile: candidates kept per P row
P_TILE = 256   # P rows per tile (the last one may be partial)


def _tile_ok(p_count, q_count, live, n_pt, n_qt, q_tile):
    """[B, ceil(P/256), Q/q_tile] bool: tiles the gate evaluates — within the
    tile-granular bound of the valid-lane counts (at least one tile) and
    live."""
    dev = p_count.device
    pt = torch.clamp((p_count + P_TILE - 1) // P_TILE, 1, n_pt)
    qt = torch.clamp((q_count + q_tile - 1) // q_tile, 1, n_qt)
    ok = ((torch.arange(n_pt, device=dev)[None, :, None] < pt[:, None, None])
          & (torch.arange(n_qt, device=dev)[None, None, :] < qt[:, None, None]))
    if live is not None:
        ok = ok & (live != 0)
    return ok


def dense_gate_reference(p_feat, q_feat, p_cell, q_cell, rp, rq, alpha, tol,
                         dist_thresh, rand_mask, marker, *, q_tile: int,
                         skip_dist: bool, p_count, q_count, live=None,
                         n_sub: int = SUB, check_cos: bool = True):
    """Plain torch version of the kernel (same arguments as dense_gate).
    Returns (row_best [B, P, n_sub] int32, counts [B, P] int32)."""
    b_n, _, p = p_feat.shape
    q = q_feat.shape[2]
    n_pt, n_qt = -(-p // P_TILE), q // q_tile
    w = q_tile // n_sub
    dev = p_feat.device
    row_ok = torch.repeat_interleave(
        _tile_ok(p_count, q_count, live, n_pt, n_qt, q_tile), P_TILE, dim=1
    )[:, :p]                                           # [B, P, n_qt]
    tol32 = torch.tensor(tol, dtype=torch.float32, device=dev)
    thr32 = torch.tensor(dist_thresh, dtype=torch.float32, device=dev)
    row_best = torch.zeros((b_n, p, n_sub), dtype=torch.int32, device=dev)
    counts = torch.zeros((b_n, p), dtype=torch.int32, device=dev)
    for b in range(b_n):
        e1, n1, sq1 = p_feat[b, 0:3], p_feat[b, 3:6], p_feat[b, 6]
        for j in range(n_qt):
            cs = slice(j * q_tile, (j + 1) * q_tile)
            e2, n2, sq2 = q_feat[b, 0:3, cs], q_feat[b, 3:6, cs], q_feat[b, 6, cs]
            match = p_cell[b][:, None] == q_cell[b, cs][None, :]
            if check_cos:
                cos = ((n1[0][:, None] * n2[0][None, :]
                        + n1[1][:, None] * n2[1][None, :])
                       + n1[2][:, None] * n2[2][None, :])
                match &= torch.abs(cos - alpha[b]) <= tol32
            if not skip_dist:
                dot = (e1[0][:, None] * e2[0][None, :]
                       + e1[1][:, None] * e2[1][None, :]) + e1[2][:, None] * e2[2][None, :]
                d2 = (sq1[:, None] + sq2[None, :]) - 2.0 * dot
                match &= d2 <= thr32
            match &= row_ok[b, :, j][:, None]
            cols = torch.arange(j * q_tile, (j + 1) * q_tile, dtype=torch.int32,
                                device=dev)
            key = ((rp[b][:, None] ^ rq[b, cs][None, :]) & rand_mask) | marker | cols
            v = torch.where(match, key, 0)
            row_best[b] = torch.maximum(row_best[b], v.view(p, n_sub, w).amax(-1))
            counts[b] += match.sum(-1, dtype=torch.int32)
    return row_best, counts


_kernel = None   # the bound C function, resolved at the first CUDA call


def _check_kernel_args(dev, p_feat, q_feat, p_cell, q_cell, rp, rq, alpha,
                       p_count, q_count, live, q_tile):
    """Raise on what the kernel does not take: every tensor on `dev`,
    contiguous, of its dtype and shape. One pass over the arguments; only a
    failure goes through them again to name the offender."""
    b_n, _, p = p_feat.shape
    q = q_feat.shape[2]
    f32, i32 = torch.float32, torch.int32
    args = [("p_feat", p_feat, f32, (b_n, 8, p)), ("q_feat", q_feat, f32, (b_n, 8, q)),
            ("p_cell", p_cell, i32, (b_n, p)), ("q_cell", q_cell, i32, (b_n, q)),
            ("rp", rp, i32, (b_n, p)), ("rq", rq, i32, (b_n, q)),
            ("alpha", alpha, f32, (b_n,)), ("p_count", p_count, i32, (b_n,)),
            ("q_count", q_count, i32, (b_n,))]
    if live is not None:
        args.append(("live", live, i32, (b_n, -(-p // P_TILE), q // q_tile)))
    if all(t.dtype == dtype and t.shape == shape and t.device == dev
           and t.is_contiguous() for _name, t, dtype, shape in args):
        return
    for name, t, dtype, shape in args:
        if t.device != dev:
            raise ValueError(f"dense_gate: {name} is on {t.device}, not {dev}")
        if t.dtype != dtype:
            raise TypeError(f"dense_gate: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"dense_gate: {name} must have shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"dense_gate: {name} must be contiguous")


def dense_gate(p_feat, q_feat, p_cell, q_cell, rp, rq, alpha, tol,
               dist_thresh, rand_mask, marker, *, q_tile: int,
               skip_dist: bool, p_count, q_count, live=None,
               n_sub: int = SUB, check_cos: bool = True):
    """Row-stripe-max selection over the full [P, Q] gate of each base.

    p_feat/q_feat [B, 8, P] / [B, 8, Q] f32, p_cell/q_cell [B, P] / [B, Q]
    int32, rp/rq [B, P] / [B, Q] int32, alpha [B] f32, p_count/q_count [B]
    int32 valid-lane counts (lanes compacted valid-first), live optional
    [B, ceil(P/256), Q/q_tile] int32 tile liveness; tol, dist_thresh floats
    and rand_mask, marker ints. Q is a multiple of q_tile, and n_sub (at
    most 16) divides q_tile. skip_dist elides the distance test (legal only
    when cell equality implies it, congruent.d2_test_implied); check_cos
    False elides the cone tolerance test. Returns (row_best [B, P, n_sub]
    int32, counts [B, P] int32).

    CUDA tensors launch the kernel (built at first use) and count
    `k1.launches`; CPU tensors take the plain version. Nothing else is
    accepted."""
    global _kernel
    dev = p_feat.device
    b_n, _, p = p_feat.shape
    q = q_feat.shape[2]
    if (q_tile < 1 or q % q_tile or not 1 <= n_sub <= SUB or q_tile % n_sub
            or p < 1):
        raise ValueError(
            f"dense_gate: Q={q} must be a multiple of q_tile={q_tile}, and "
            f"n_sub={n_sub} in [1, {SUB}] must divide q_tile (P={p})"
        )
    if dev.type == "cpu":
        return dense_gate_reference(
            p_feat, q_feat, p_cell, q_cell, rp, rq, alpha, tol, dist_thresh,
            rand_mask, marker, q_tile=q_tile, skip_dist=skip_dist,
            p_count=p_count, q_count=q_count, live=live, n_sub=n_sub,
            check_cos=check_cos,
        )
    if dev.type != "cuda":
        raise ValueError(f"dense_gate: unsupported device {dev}")
    _check_kernel_args(dev, p_feat, q_feat, p_cell, q_cell, rp, rq, alpha,
                       p_count, q_count, live, q_tile)
    if not (0 <= rand_mask < 2 ** 31 and 0 <= marker < 2 ** 31):
        raise ValueError("dense_gate: rand_mask and marker must be int32 >= 0")
    if b_n > 65535:
        raise ValueError(f"dense_gate: at most 65535 bases a launch, got {b_n}")

    if _kernel is None:
        _kernel = _build.load().mm_dense_gate
    # the kernel writes every element of both outputs (zero for rows of
    # dead or skipped tiles)
    row_best = p_cell.new_empty((b_n, p, n_sub))
    counts = p_cell.new_empty((b_n, p))
    err = _build.launch(
        dev, _kernel,
        p_feat.data_ptr(), q_feat.data_ptr(), p_cell.data_ptr(),
        q_cell.data_ptr(), rp.data_ptr(), rq.data_ptr(), alpha.data_ptr(),
        p_count.data_ptr(), q_count.data_ptr(),
        None if live is None else live.data_ptr(),
        row_best.data_ptr(), counts.data_ptr(),
        b_n, p, q, q_tile, n_sub, float(tol), float(dist_thresh),
        int(rand_mask), int(marker), int(bool(skip_dist)),
        int(bool(check_cos)),
    )
    if err != 0:
        raise RuntimeError(f"dense_gate: CUDA kernel launch failed (error {err})")
    trace.count("k1.launches")
    return row_best, counts


def gate_rows(b_n: int, p: int, device) -> int:
    """The P rows one block of the kernel owns in a launch of b_n bases of
    P lanes on the CUDA `device`: the launcher's own choice (a multiple of
    16, so a block may straddle two P_TILE-row tiles)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"dense_gate.gate_rows: {dev} is not a CUDA device")
    rows = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = _build.load().mm_dense_gate_rows(b_n, p, ctypes.byref(rows))
    if err != 0:
        raise RuntimeError(f"dense_gate.gate_rows: CUDA error {err}")
    return rows.value
