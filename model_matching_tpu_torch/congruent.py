"""Congruent 4-point set extraction on the model.

Counterpart of ``model_matching_tpu/congruent.py``. Per base, the two PPF
lookups give padded pair lists from the model's table; the gate between
the lists keeps (P, Q) pairs whose interpolated points e1/e2 share a
position cell of the reference's power-of-two unit-cube grid, whose
directions pass the cone test, and (unless implied by the cell) whose
squared distance passes the reference's unsquared-threshold check. A keyed
random top-k over the matches is the reference's random subsample.

Dispatch: the JAX package sorts bases by pair load inside one jitted
program and picks a tier per group of G bases with ``lax.cond``. Here the
host reads the group maxima once, buckets the bases by tier, and runs each
tier once for all of its bases: the small tiers as batched tensor ops, the
dense tiers (cap >= _PALLAS_MIN_CAP) through ONE dense-gate call
(ops/dense_gate.py) for all of the tier's bases — the CUDA kernel for
tensors on the card, its plain version for tensors on the CPU. Every dense
tier takes that gate, whatever its shape, distance mode or cos tolerance,
and whatever ``congruent_pallas`` says: the JAX package's Pallas kernel and
its XLA dense path compute the same function (its own bit-equality
contract), so the field has nothing to choose here and is kept only for
config parity. Every base keeps its own key and tier, so the outputs equal
the JAX package's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import rng
from .config import MatchConfig
from .ops import fmath
from .ops.dense_gate import dense_gate
from .ops.fp import div_const, dot3, f32, fma, sqrt_rn
from .ops.ppf import ppf_bins
from .utils import trace
from .ppf_table import (
    PPFTable,
    _mix32,
    gather_pair_block_srcs,
    gather_pair_srcs,
    lookup_pair_range,
)

# smallest pair cap routed to the dense gate
_PALLAS_MIN_CAP = 4096

# IndexedNormalSet angular-grid constants (7 cells per dimension)
_NG = 7
_NEPS = 1.0 / _NG + 0.00001
# largest cone sample count over alpha in [0, pi]: 2 * ceil(2*pi*atan(pi) * 7/2)
_CONE_MAX_SAMPLES = 56
# angular cell ids live in [0, 342]; clipped to [0, 349], dead samples at 350
_CONE_OH_W = 352

_INT32_MAX = 0x7FFFFFFF


def _normal_cell_id(n):
    """Angular cell id of a unit direction (the reference's
    coordinatesNormal map + linearization); overshoot is not clipped."""
    c = torch.floor(div_const(n / 2.0 + 0.5, _NEPS)).to(torch.int32)
    return c[..., 0] + c[..., 1] * _NG + c[..., 2] * (_NG * _NG)


def _rot_from_z_to(n):
    """Rotation matrix of the quaternion that turns (0,0,1) into n [..., 3]
    (half-angle construction); the antiparallel case is diag(1, -1, -1)."""
    c = n[..., 2]
    s = sqrt_rn(torch.clamp((1.0 + c) * 2.0, min=1e-24))
    w = s / 2.0
    x = -n[..., 1] / s
    y = n[..., 0] / s
    one = torch.ones_like(c)
    r = torch.stack([
        torch.stack([1 - 2 * y * y, 2 * x * y, 2 * w * y], dim=-1),
        torch.stack([2 * x * y, 1 - 2 * x * x, -2 * w * x], dim=-1),
        torch.stack([-2 * w * y, 2 * w * x, 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)
    zero = 0 * c
    anti = torch.stack([
        torch.stack([one, zero, zero], dim=-1),
        torch.stack([zero, -one, zero], dim=-1),
        torch.stack([zero, zero, -one], dim=-1),
    ], dim=-2)
    return torch.where((c < -1.0 + 1e-12)[..., None, None], anti, r)


def _unit(v):
    return v / torch.clamp(sqrt_rn(dot3(v, v)), min=1e-30)[..., None]


def _cone_trig(cos_alpha):
    """The trigonometry of the reference's cone rasterization for bases at
    angle acos(cos_alpha [B]), taken once for all tiers: (local [B, S, 3]
    sample directions about +z, live [B, S] bool, nb [B] sample count)."""
    ang = fmath.acos(torch.clamp(cos_alpha, -1.0, 1.0))
    # the reference's quirks: perimeter from atan(angle), zero samples at 0
    perimeter = 2.0 * math.pi * fmath.atan(ang)
    nb = 2.0 * torch.ceil(perimeter * _NG / 2.0)
    step = 2.0 * math.pi / torch.clamp(nb, min=1.0)
    a = torch.arange(_CONE_MAX_SAMPLES, dtype=torch.float32, device=cos_alpha.device)
    theta = a[None, :] * step[:, None]                     # [B, S]
    # one sin/cos pass over the cone angles and the sample angles
    sin, cos = fmath.sincos(torch.cat([ang[:, None], theta], dim=1))
    sin_a = sin[:, :1]
    local = torch.stack([
        sin_a * cos[:, 1:],
        sin_a * sin[:, 1:],
        cos_alpha[:, None].expand_as(theta),
    ], dim=-1)                                             # [B, S, 3]
    return local, (a[None, :] < nb[:, None]), nb


def _cone_samples(dir_q, cone):
    """Cells of the cone rasterization around directions dir_q [n, L, 3]
    for n bases' _cone_trig rows: (cells [n, L, S] int32, live [n, S] bool,
    nb [n] sample count)."""
    local, live, nb = cone
    d = _unit(torch.einsum("nlij,nsj->nlsi", _rot_from_z_to(_unit(dir_q)), local))
    return _normal_cell_id(d), live, nb


def _colored_mask(dir_q, cone):
    """[n, _CONE_OH_W, L] bool: angular cell c is colored by the cone
    rasterization around Q lane l (dead samples park at cell 350, which no
    P cell reaches)."""
    cells, live, nb = _cone_samples(dir_q, cone)
    live = live & (nb > 0)[:, None]
    cells = torch.where(live[:, None, :], torch.clamp(cells, 0, 349), 350)
    n, l_n, _s = cells.shape
    out = torch.zeros((n, l_n, _CONE_OH_W), dtype=torch.bool, device=cells.device)
    out.scatter_(2, cells.long(), True)
    return out.transpose(1, 2)


def _cell_index(dir_p):
    """[n, L] clipped angular cell of each P direction (the P side of the
    in-gate exact cone test)."""
    return torch.clamp(_normal_cell_id(_unit(dir_p)), 0, 349)


def _cone_accept(dir_p, dir_q, cone):
    """Literal cone-rasterization membership of the reference: the angular
    cell of dir_p [n, K, 3] is one of the cells colored around dir_q
    [n, K, 3] by the n bases' _cone_trig rows."""
    cell_p = _normal_cell_id(_unit(dir_p))
    cells, live, nb = _cone_samples(dir_q, cone)
    hit = ((cells == cell_p[..., None]) & live[:, None, :]).any(dim=-1)
    return hit & (nb > 0)[:, None]


def tier_plan(p_cap: int):
    """(tiers, top): the ascending [(cap, q_block)] tiers below the top
    tier and the top tier (p_cap, q_block). 64..4096 run the full gate;
    8192 and up block the Q axis in 4096-pair chunks."""
    tiers = [
        (c, None) for c in (64, 128, 256, 512, 1024, 2048, 4096) if c < p_cap
    ]
    if p_cap > 8192:
        tiers.append((8192, 4096))
    if p_cap > 16384:
        tiers.append((16384, 4096))
    return tiers, (p_cap, 4096 if p_cap >= 8192 else None)


def _topk_segmented(x: torch.Tensor, k: int):
    """Exact top-k over the last axis with lax.top_k's order: values
    descending, equal values by ascending index. A stable descending sort
    gives that order directly (torch.topk does not promise it)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class CongruentSets(NamedTuple):
    pairs: torch.Tensor        # [B, K, 2] int32 rows into table.pairs (P, Q)
    quad_valid: torch.Tensor   # [B, K] bool
    total_found: torch.Tensor  # [B] int32 (pre-cap count)
    pair_counts: torch.Tensor  # [B, 2] int32 (|P_pairs|, |Q_pairs|)


def selection_shortfall(sets: CongruentSets, cfg: MatchConfig):
    """Device-side count of bases that kept fewer than
    maximum_congruent_sets although the gate matched at least
    oversample * k candidates (the dense tiers' exact-cone re-check
    under-filling)."""
    k_cap = cfg.maximum_congruent_sets
    k_sel = k_cap * max(1, cfg.congruent_cone_oversample)
    kept = sets.quad_valid.sum(dim=1, dtype=torch.int32)
    return ((sets.total_found >= k_sel) & (kept < k_cap)).sum(dtype=torch.int32)


def quads_of(table: PPFTable, pairs: torch.Tensor) -> torch.Tensor:
    """[..., 2] winner pair rows -> [..., 4] model point indices (p1, p2,
    q1, q2). The fit reads endpoint positions from ModelPack.pair_ep
    instead; this is for callers that want the indices."""
    return table.pairs[pairs.long()].reshape(pairs.shape[:-1] + (4,))


def _unit_cube_params(model_pos):
    """The reference's unit-cube normalization: center = bbox center,
    ratio = largest bbox extent + 0.001."""
    lo = model_pos.amin(dim=0)
    hi = model_pos.amax(dim=0)
    return (lo + hi) * 0.5, (hi - lo + 0.001).amax()


def d2_test_implied(model_pos, cfg: MatchConfig) -> bool:
    """Host-side check: does same-cell membership imply the distance test
    (so the gate can skip it)? Reads the model positions once. Stacked [O,
    M, 3] positions (multi.py) must hold for every object."""
    if cfg.congruent_distance_mode != "cell":
        return False
    trace.count("host_reads")
    mp = np.asarray(model_pos.detach().cpu().numpy(), dtype=np.float32)
    return all(_d2_implied_host(m, cfg) for m in mp.reshape((-1,) + mp.shape[-2:]))


def _d2_implied_host(mp: np.ndarray, cfg: MatchConfig) -> bool:
    lo, hi = mp.min(axis=0), mp.max(axis=0)
    ratio = np.float32((hi - lo + np.float32(0.001)).max())
    eps_n = np.float32(cfg.distance_threshold) / ratio
    eg_size = np.exp2(np.trunc(-np.log2(eps_n)))
    cell = float(ratio / eg_size)
    thresh = (
        cfg.distance_threshold
        if cfg.congruent_sqdist_quirk
        else cfg.distance_threshold ** 2
    )
    return 4.5 * cell * cell <= thresh


def _as_int32_bits(u):
    """int64 holding uint32 values -> int32 with the same bits."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def extract_congruent_sets(
    key: torch.Tensor,
    table: PPFTable,
    model_pos: torch.Tensor,     # [M, 3] centered model positions
    scene_pos: torch.Tensor,     # [N, 3] centered scene positions
    scene_normal: torch.Tensor,  # [N, 3]
    base_indices: torch.Tensor,  # [B, 4] reordered base indices
    invariant1: torch.Tensor,    # [B]
    invariant2: torch.Tensor,    # [B]
    base_valid: torch.Tensor,    # [B]
    cfg: MatchConfig,
    pair_ep: torch.Tensor | None = None,  # [total_pairs, 6] ModelPack.pair_ep
    d2_implied: bool | None = None,       # None = auto (d2_test_implied)
) -> CongruentSets:
    """Congruent sets of every base, dispatched in host-side tier buckets
    (see the module docstring)."""
    if d2_implied is None:
        d2_implied = d2_test_implied(model_pos, cfg)
    dev = scene_pos.device
    center, ratio = _unit_cube_params(model_pos)
    # power-of-two cell of the reference's IndexedNormalSet grid
    # (eps / ratio as a correctly rounded float32 quotient, log2 as the JAX
    # package's compiled log times 1 / ln 2, and the power of two built
    # from its exponent bits: exact on every device)
    eps_n = (torch.full_like(ratio, f32(cfg.distance_threshold), dtype=torch.float64)
             / ratio.double()).float()
    depth = torch.clamp(torch.trunc(-fmath.log2(eps_n)), -126, 127).to(torch.int32)
    eg_size = ((depth + 127) << 23).view(torch.float32)

    p_cap = cfg.max_pairs_per_bin
    k_cap = cfg.maximum_congruent_sets
    tiers, top = tier_plan(p_cap)
    b = base_indices.shape[0]
    salts = rng.bits_batched(rng.split(key, b), dev)          # [B]
    tr, rot = cfg.ppf_tr_discretization, cfg.ppf_rot_discretization

    # one batched PPF-lookup pass for all bases
    bidx = base_indices.long()
    bp, bn = scene_pos[bidx], scene_normal[bidx]              # [B, 4, 3]
    off1, cnt1 = lookup_pair_range(
        table, ppf_bins(bp[:, 0], bn[:, 0], bp[:, 1], bn[:, 1], tr, rot))
    off2, cnt2 = lookup_pair_range(
        table, ppf_bins(bp[:, 2], bn[:, 2], bp[:, 3], bn[:, 3], tr, rot))
    p_total = cnt1.sum(-1, dtype=torch.int32)
    q_total = cnt2.sum(-1, dtype=torch.int32)

    # angle between the two base segments
    d01 = bp[:, 1] - bp[:, 0]
    d23 = bp[:, 3] - bp[:, 2]
    alpha = dot3(
        d01 / torch.clamp(sqrt_rn(dot3(d01, d01)), min=1e-30)[:, None],
        d23 / torch.clamp(sqrt_rn(dot3(d23, d23)), min=1e-30)[:, None],
    )

    # tier of every base: sorted groups of g share the tier of their
    # largest load (one host read of the group maxima); g <= 1 or a single
    # tier picks per base
    g = max(1, cfg.congruent_sorted_groups)
    while g > 1 and b % g:
        g -= 1
    caps = [c for c, _ in tiers]
    tier_of = np.full(b, len(tiers), np.int64)   # len(tiers) = the top tier
    if g > 1 and tiers:
        loads = torch.maximum(p_total, q_total)
        order = torch.sort(loads, stable=True).indices
        gmax = loads[order].view(b // g, g).amax(1)
        trace.count("host_reads")
        host = torch.cat([order, gmax.to(order.dtype)]).cpu().numpy()
        host_order, host_gmax = host[:b], host[b:]
        group_tier = np.searchsorted(np.asarray(caps), host_gmax, side="left")
        tier_of[host_order] = np.repeat(group_tier, g)
    elif tiers:
        trace.count("host_reads")
        host_load = torch.maximum(p_total, q_total).cpu().numpy()
        tier_of[:] = np.searchsorted(np.asarray(caps), host_load, side="left")

    pairs = torch.zeros((b, k_cap, 2), dtype=torch.int32, device=dev)
    quad_valid = torch.zeros((b, k_cap), dtype=torch.bool, device=dev)
    totals = torch.zeros(b, dtype=torch.int32, device=dev)
    ctx = dict(
        table=table, model_pos=model_pos, pair_ep=pair_ep, cfg=cfg,
        d2_implied=d2_implied, center=center, ratio=ratio, eg_size=eg_size,
    )
    cone = _cone_trig(alpha)
    for ti, (cap, q_block) in enumerate(tiers + [top]):
        members = np.flatnonzero(tier_of == ti)
        if members.size == 0:
            continue
        for chunk in _member_chunks(members, cap, q_block, pair_ep):
            sel = torch.from_numpy(chunk).to(dev)
            p_, v_, t_ = _match_tier(
                ctx, cap, q_block, salts[sel], alpha[sel], invariant1[sel],
                invariant2[sel], base_valid[sel], off1[sel], cnt1[sel],
                off2[sel], cnt2[sel], tuple(t[sel] for t in cone),
            )
            pairs[sel], quad_valid[sel], totals[sel] = p_, v_, t_
    return CongruentSets(pairs, quad_valid, totals,
                         torch.stack([p_total, q_total], dim=-1))


def _tier_shape(cap, q_block, pair_ep):
    """(lanes per side, Q chunk width, blocked, slack) of a tier. Dense
    tiers with endpoint rows gather in 4-pair blocks with a slack that
    makes every Q chunk a multiple of 256 lanes."""
    nb = cap // (q_block or cap)
    blocked = pair_ep is not None and cap >= 2048
    slack = 0
    lanes = cap
    if blocked:
        blk, m = 4, nb * 256
        rem = (cap + blk * 128) % m
        slack = 128 + ((m - rem) // blk if rem else 0)
        lanes = (cap // blk + slack) * blk
    if lanes % nb:
        raise ValueError(
            f"tier cap {cap}: {lanes} lanes do not split into {nb} Q chunks")
    return lanes, lanes // nb, blocked, slack


def _member_chunks(members, cap, q_block, pair_ep):
    """Split a tier's bases into batches. Dense tiers take all of them in
    one dense-gate call; the small tensor-gate tiers bound the batched
    [n, P, Q] gate transient at ~2^24 elements."""
    if cap >= _PALLAS_MIN_CAP:
        return [members]
    lanes, chunk, _b, _s = _tier_shape(cap, q_block, pair_ep)
    w = max(1, (1 << 24) // (lanes * chunk))
    return [members[i:i + w] for i in range(0, members.size, w)]


def _match_tier(ctx, cap, q_block, salt, alpha, inv1, inv2, bvalid,
                off1, cnt1, off2, cnt2, cone):
    """Gate + random-subsample selection of n bases at one tier: gather up
    to `cap` pairs per side (block-granular in the dense tiers when the
    endpoint rows exist), gate, reduce to stripe maxima, select."""
    table, model_pos, pair_ep = ctx["table"], ctx["model_pos"], ctx["pair_ep"]
    cfg, d2_implied = ctx["cfg"], ctx["d2_implied"]
    center, ratio, eg_size = ctx["center"], ctx["ratio"], ctx["eg_size"]
    n = salt.shape[0]
    dev = salt.device
    k_cap = cfg.maximum_congruent_sets
    nb = cap // (q_block or cap)
    _l, _c, blocked, slack = _tier_shape(cap, q_block, pair_ep)
    dense = cap >= _PALLAS_MIN_CAP
    npairs = table.pairs.shape[0]
    blk = 4

    if blocked:
        epb = pair_ep.view(-1, 6 * blk)

        def side(off, cnt):
            bsrc, lok, _t = gather_pair_block_srcs(table, off, cnt, cap, blk, slack)
            lanes = bsrc.shape[-1] * blk
            rows = epb[bsrc.long()].view(n, lanes, 6)
            bcnt = torch.where(
                cnt > 0, (off + cnt + blk - 1) // blk - off // blk, 0)
            nlanes = torch.clamp(bcnt.sum(-1, dtype=torch.int32),
                                 max=bsrc.shape[-1]) * blk
            return rows, lok.view(n, lanes), nlanes
    else:
        def side(off, cnt):
            src, ok, _t = gather_pair_srcs(table, off, cnt, cap)
            if pair_ep is not None:
                rows = pair_ep[src.long()]
            else:
                pr = table.pairs[src.long()].long()
                rows = torch.cat([model_pos[pr[..., 0]], model_pos[pr[..., 1]]], -1)
            nlanes = torch.clamp(cnt.sum(-1, dtype=torch.int32), max=cap)
            return rows, ok, nlanes

    def decode(sel, off, cnt):
        # winner lane -> table.pairs row, closed form over the CSR ranges;
        # lanes outside every range decode to themselves, clipped (masked
        # downstream by quad_valid)
        if blocked:
            bstart = off // blk
            bcnt = torch.where(cnt > 0, (off + cnt + blk - 1) // blk - bstart, 0)
            cumb = torch.cumsum(bcnt, -1, dtype=torch.int32) - bcnt
            t = sel // blk
            hit = ((cumb[:, None, :] <= t[..., None])
                   & (t[..., None] < (cumb + bcnt)[:, None, :]))
            gi = t + torch.where(hit, (bstart - cumb)[:, None, :], 0).sum(-1)
            src = gi * blk + sel % blk
        else:
            start = torch.cumsum(cnt, -1, dtype=torch.int32) - cnt
            hit = ((start[:, None, :] <= sel[..., None])
                   & (sel[..., None] < (start + cnt)[:, None, :]))
            src = sel + torch.where(hit, (off - start)[:, None, :], 0).sum(-1)
        return torch.clamp(src, 0, npairs - 1)

    def seg_from_rows(rows, inv):
        # interpolated point e = a + inv * (b - a) in world and unit-cube
        # coordinates, and the unit pair direction; e is one fused
        # multiply-add, as the JAX package computes it (ops/fp.py), since
        # its cell id is a floor
        aw, d = rows[..., 0:3], rows[..., 3:6] - rows[..., 0:3]
        e_world = fma(inv[:, None, None].expand_as(d), d, aw)
        e_unit = (e_world - center) / ratio + 0.5
        dirs = d / torch.clamp(sqrt_rn(dot3(d, d)), min=1e-30)[..., None]
        return e_unit, e_world, dirs

    def pack(e_unit):
        c = torch.floor(e_unit * eg_size).to(torch.int32)
        return (c[..., 0] * 1024 + c[..., 1]) * 1024 + c[..., 2]

    p_rows, p_ok, p_lanes = side(off1, cnt1)
    q_rows, q_ok, q_lanes = side(off2, cnt2)
    pl, ql = p_rows.shape[1], q_rows.shape[1]
    chunk = ql // nb

    # dense tiers at or above the band cap sort each side's lanes by cell
    # id (invalid lanes last, stable), so the gate can skip (P tile, Q
    # tile) pairs whose cell ranges cannot overlap
    banded = cap >= max(cfg.congruent_band_min_cap, _PALLAS_MIN_CAP)
    if banded:
        def cell_sort(rows, ok, inv):
            e_unit, _e, _d = seg_from_rows(rows, inv)
            ck = torch.where(ok, pack(e_unit), _INT32_MAX)
            ck_s, perm = torch.sort(ck, dim=-1, stable=True)
            take = lambda a: torch.gather(
                a, 1, perm.view(perm.shape + (1,) * (a.dim() - 2)).expand_as(a))
            return (take(rows), take(ok), ck_s, perm,
                    ok.sum(-1, dtype=torch.int32))

        p_rows, p_ok, kp_s, perm_p, p_lanes = cell_sort(p_rows, p_ok, inv1)
        q_rows, q_ok, kq_s, perm_q, q_lanes = cell_sort(q_rows, q_ok, inv2)

    e1_unit, e1_world, n1 = seg_from_rows(p_rows, inv1)
    cell1p = pack(e1_unit)
    sq1 = dot3(e1_world, e1_world)
    e2_unit, e2_world, n2 = seg_from_rows(q_rows, inv2)
    cell2p = pack(e2_unit)
    sq2 = dot3(e2_world, e2_world)

    # keyed random subsample: key = (rand_p ^ rand_q) | marker | column,
    # a positive int32 whose max both samples and records the winner
    rp = _mix32(torch.arange(pl, device=dev)[None, :] ^ salt[:, None])  # [n, pl]
    col_bits = max(14, (ql - 1).bit_length())
    marker = 1 << col_bits
    rand_mask = 0x7FFFFFFF & ~((1 << (col_bits + 1)) - 1)

    cell_mode = cfg.congruent_distance_mode == "cell"
    if cell_mode:
        dist_thresh = (cfg.distance_threshold if cfg.congruent_sqdist_quirk
                       else cfg.distance_threshold ** 2)
    else:
        dist_thresh = cfg.distance_threshold ** 2

    # small tiers run the exact cone rasterization inside the gate; dense
    # tiers keep the cos-tolerance gate and re-check selected winners
    exact_in_gate = cfg.congruent_exact_cone and not dense

    if dense:
        # contiguous stripes: 16 per Q chunk, fewer when 16 does not divide it
        sub = 16
        while chunk % sub:
            sub //= 2

        def feat(e, dirs, sq):
            return torch.cat([e.transpose(1, 2), dirs.transpose(1, 2), sq[:, None],
                              torch.zeros_like(sq)[:, None]], dim=1).contiguous()

        rq_all = _mix32(torch.arange(ql, device=dev)[None, :] ^ salt[:, None]
                        ^ 0x9E3779B9)
        live = None
        if banded and cell_mode:
            # a (P tile, Q chunk) pair is live when the sorted cell ranges
            # of its lanes overlap (a superset test: no match is lost)
            pt = 256
            last_p = torch.clamp(torch.arange(pt - 1, pl + pt - 1, pt, device=dev),
                                 max=pl - 1)
            clo_p, chi_p = kp_s[:, ::pt], kp_s[:, last_p]
            clo_q, chi_q = kq_s[:, ::chunk], kq_s[:, chunk - 1::chunk]
            live = ((clo_p[:, :, None] <= chi_q[:, None, :])
                    & (clo_q[:, None, :] <= chi_p[:, :, None])).to(torch.int32)
        # the radius mode has no cell test: every valid lane gets cell 0
        c1 = cell1p if cell_mode else torch.zeros_like(cell1p)
        c2 = cell2p if cell_mode else torch.zeros_like(cell2p)
        rb, row_counts = dense_gate(
            feat(e1_world, n1, sq1), feat(e2_world, n2, sq2),
            torch.where(p_ok, c1, -1).to(torch.int32).contiguous(),
            torch.where(q_ok, c2, -2).to(torch.int32).contiguous(),
            _as_int32_bits(rp).contiguous(), _as_int32_bits(rq_all).contiguous(),
            alpha.contiguous(), cfg.congruent_cos_tolerance, dist_thresh,
            rand_mask, marker, q_tile=chunk, skip_dist=d2_implied,
            p_count=p_lanes.to(torch.int32).contiguous(),
            q_count=q_lanes.to(torch.int32).contiguous(),
            live=None if live is None else live.contiguous(),
            n_sub=sub, check_cos=cfg.congruent_cos_tolerance >= 0,
        )
        row_best = torch.where(bvalid[:, None, None], rb, 0)
        total = torch.where(bvalid, row_counts.sum(-1, dtype=torch.int32), 0)
    else:
        # small tiers: strided stripes (column c -> stripe c % sub) with
        # topn successive maxima per stripe; narrow tiers select exactly
        if nb != 1:
            raise ValueError(f"small tier cap {cap} cannot split its Q axis")
        topn = max(1, cfg.congruent_stripe_topn)
        sub = max(128, min(cfg.congruent_sel_stripes, chunk))
        while chunk % sub:
            sub //= 2
        full_sel = topn * sub >= chunk
        match = p_ok[:, :, None] & q_ok[:, None, :] & bvalid[:, None, None]
        if cell_mode:
            match &= cell1p[:, :, None] == cell2p[:, None, :]
        if not d2_implied:
            d2 = (sq1[:, :, None] + sq2[:, None, :]
                  - 2.0 * torch.bmm(e1_world, e2_world.transpose(1, 2)))
            match &= d2 <= dist_thresh
        if exact_in_gate:
            colored = _colored_mask(n2, cone)                   # [n, 352, ql]
            nidx = torch.arange(n, device=dev)[:, None]
            match &= colored[nidx, _cell_index(n1).long()]
        elif cfg.congruent_cos_tolerance >= 0:
            cos = torch.bmm(n1, n2.transpose(1, 2))
            match &= (torch.abs(cos - alpha[:, None, None])
                      <= cfg.congruent_cos_tolerance)
        cols = torch.arange(ql, device=dev)
        rq = _mix32(cols[None, :] ^ salt[:, None] ^ 0x9E3779B9)
        v = ((rp[:, :, None] ^ rq[:, None, :]) & rand_mask) | marker | cols
        v = torch.where(match, v, 0)
        total = match.sum((1, 2), dtype=torch.int32)
        if full_sel:
            row_best = v
        else:
            vs = v.view(n, pl, ql // sub, sub)
            # keys are unique within a row, so masking the running max and
            # reducing again is an exact successive maximum
            outs = [vs.amax(dim=2)]
            cur = vs
            for _ in range(topn - 1):
                cur = torch.where(cur == outs[-1][:, :, None, :], 0, cur)
                outs.append(cur.amax(dim=2))
            row_best = outs[0] if topn == 1 else torch.cat(outs, dim=-1)

    # selection: the small tiers' matches are true congruent sets, so a
    # random top-k suffices; the dense tiers select oversample * k winners,
    # re-check each with the literal cone rasterization, and keep the top k
    recheck = cfg.congruent_exact_cone and not exact_in_gate
    width = row_best.shape[-1]
    flat = row_best.reshape(n, -1).to(torch.int64)
    k_sel = k_cap
    if recheck:
        k_sel = min(k_cap * max(1, cfg.congruent_cone_oversample), flat.shape[1])
    top, slot = _topk_segmented(flat, k_sel)
    gate_ok = top > 0
    pi = slot // width
    qi = top & ((1 << col_bits) - 1)
    if recheck:
        take_rows = lambda rows, idx: torch.gather(
            rows, 1, idx[..., None].expand(idx.shape + (6,)))
        rp_w, rq_w = take_rows(p_rows, pi), take_rows(q_rows, qi)
        exact_ok = _cone_accept(rp_w[..., 3:6] - rp_w[..., 0:3],
                                rq_w[..., 3:6] - rq_w[..., 0:3], cone)
        top, pick = _topk_segmented(torch.where(gate_ok & exact_ok, top, 0), k_cap)
        pi = torch.gather(pi, 1, pick)
        qi = torch.gather(qi, 1, pick)
    quad_valid = top > 0
    if banded:
        pi, qi = torch.gather(perm_p, 1, pi), torch.gather(perm_q, 1, qi)
    pairs = torch.stack(
        [decode(pi, off1, cnt1), decode(qi, off2, cnt2)], dim=-1
    ).to(torch.int32)
    return pairs, quad_valid, total
