"""Probability-weighted congruent-base sampling, batched over all bases.

Counterpart of the class path of ``model_matching_tpu/sampling.py``: all B
bases run as one [B, N] tensor program of four masked categorical rounds,
with the same threefry keys (rng.py), so the port draws the JAX package's
bases. Existence checks hash the packed PPF keys directly, or read rows of
the bit-packed pair-existence matrix (``build_exists_bits``) when one is
given: the same masks, one row read per anchor.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import rng
from .ops import fmath, invariants
from .ops.fp import sqrt_rn
from .ops.ppf import ppf_keys_fast
from .ppf_table import PPFTable, ppf_exists
from .utils import trace

_RAD2DEG = 180.0 / math.pi


class SampledBases(NamedTuple):
    indices: torch.Tensor     # [B, 4] int32 — reordered scene point indices
    invariant1: torch.Tensor  # [B] f32
    invariant2: torch.Tensor  # [B] f32
    valid: torch.Tensor       # [B] bool


def log_weights(w):
    """log(max(w, 1e-30)), the logits of positive weights."""
    return fmath.log(torch.clamp(w, min=1e-30))


def _row_logits(probs, log_w):
    """([B, N] logits of the weights, [B] rows with mass): zero weights get
    -inf, and a row without mass (flagged invalid) all zeros, so that a
    draw never sees an all -inf row. `log_w` is log_weights(w) of the
    weights w that `probs` masks (each entry w or 0), taken once for the
    four draws of a base: the JAX package takes the log per draw, of the
    same values."""
    ok = probs.sum(dim=-1) > 0
    logits = torch.where(probs > 0, log_w, -torch.inf)
    return torch.where(ok[:, None], logits, 0.0), ok


def _categorical_rows_with_noise(noise, probs, log_w):
    """Per-row categorical draw over [B, N] weights with the Gumbel noise
    given (rng.categorical's draw: argmax of noise + logits); rows with zero
    mass are flagged invalid."""
    logits, ok = _row_logits(probs, log_w)
    return torch.argmax(noise + logits, dim=-1).to(torch.int32), ok


def _pairwise_exists(table: PPFTable, pos, normal, anchor_idx, tr, rot,
                     exists_bits=None):
    """[B, N] bool: does PPF(anchor_b -> i) exist in the model map (the
    anchor is point 1 of the feature). With `exists_bits` (the matrix of
    build_exists_bits) the check is one row read per anchor and an
    elementwise unpack."""
    a = anchor_idx.long()
    if exists_bits is not None:
        rows = exists_bits[a]                             # [B, N / 32] int32
        shifts = torch.arange(32, dtype=torch.int32, device=rows.device)
        unpacked = (rows[:, :, None] >> shifts) & 1
        return unpacked.reshape(rows.shape[0], -1)[:, :pos.shape[0]] > 0
    keys = ppf_keys_fast(
        pos[a][:, None, :], normal[a][:, None, :],
        pos[None, :, :], normal[None, :, :], tr, rot,
    )
    return ppf_exists(table, keys)


def build_exists_bits(table: PPFTable, pos, normal, tr, rot,
                      chunk: int = 256):
    """Bit-packed [N, N / 32] matrix of PPF(i -> j) existence, 32 pairs a
    word (bit j % 32 of word j // 32 of row i): the O(N^2) precomputation
    that turns every sampling round's existence mask into a row lookup.
    The words are int32 holding the JAX package's uint32 bit patterns
    (torch shifts no uint32 on every backend). Built on the device of
    `pos` in row blocks of `chunk`, in the span `sampling.exists_bits`
    (host time: it ends without waiting for the device)."""
    n = pos.shape[0]
    assert n % chunk == 0 and n % 32 == 0
    with trace.span("sampling.exists_bits"):
        weights = torch.ones((), dtype=torch.int64, device=pos.device) << torch.arange(
            32, dtype=torch.int64, device=pos.device)
        blocks = []
        for i in range(0, n, chunk):
            keys = ppf_keys_fast(
                pos[i:i + chunk, None, :], normal[i:i + chunk, None, :],
                pos[None, :, :], normal[None, :, :], tr, rot,
            )
            ex = ppf_exists(table, keys)                      # [chunk, n]
            word = (ex.reshape(chunk, n // 32, 32).to(torch.int64) * weights).sum(-1)
            # uint32 value -> the int32 with the same bits
            blocks.append(torch.where(word >= 2 ** 31, word - 2 ** 32, word)
                          .to(torch.int32))
        return torch.cat(blocks)


def _norm(v):
    return sqrt_rn(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def round2_keep_mask(table, pos, normal, idx1, idx2, tr, rot,
                     internal_angle_threshold, exists_bits=None):
    """[B, N] keep-mask after drawing point 2: PPF(b2 -> i) exists, i is not
    b2, and the internal angle at b1 between (b2-b1) and (i-b1), folded to
    [0, 90], is >= the threshold."""
    n = pos.shape[0]
    arange_n = torch.arange(n, dtype=torch.int32, device=pos.device)[None, :]
    p1 = pos[idx1.long()]
    v1 = pos[idx2.long()] - p1
    v1 = v1 / torch.clamp(_norm(v1), min=1e-30)[..., None]
    v2 = pos[None, :, :] - p1[:, None, :]
    v2 = v2 / torch.clamp(_norm(v2), min=1e-30)[..., None]
    cosang = (v1[:, None, 0] * v2[..., 0] + v1[:, None, 1] * v2[..., 1]
              + v1[:, None, 2] * v2[..., 2])
    angle = fmath.acos(torch.clamp(cosang, -1.0, 1.0)) * _RAD2DEG
    angle = torch.minimum(angle, 180.0 - angle)
    exists = _pairwise_exists(table, pos, normal, idx2, tr, rot, exists_bits)
    return exists & (arange_n != idx2[:, None]) & ~(angle < internal_angle_threshold)


def _det3(m):
    """Closed-form 3x3 determinant (jnp.linalg.det's expression)."""
    return (m[..., 0, 0] * m[..., 1, 1] * m[..., 2, 2]
            + m[..., 0, 1] * m[..., 1, 2] * m[..., 2, 0]
            + m[..., 0, 2] * m[..., 1, 0] * m[..., 2, 1]
            - m[..., 0, 2] * m[..., 1, 1] * m[..., 2, 0]
            - m[..., 0, 0] * m[..., 1, 2] * m[..., 2, 1]
            - m[..., 0, 1] * m[..., 1, 0] * m[..., 2, 2])


def round3_keep_mask(table, pos, normal, idx1, idx2, idx3, tr, rot,
                     plane_threshold, min_distance_base, exists_bits=None):
    """[B, N] keep-mask after drawing point 3: near-coplanar with the plane
    through b1-b3 (ax+by+cz=1 via Cramer's rule), at the minimum distance
    from each of b1-b3, PPF(b3 -> i) exists, i is not b3."""
    n = pos.shape[0]
    arange_n = torch.arange(n, dtype=torch.int32, device=pos.device)[None, :]
    p1, p2, p3 = pos[idx1.long()], pos[idx2.long()], pos[idx3.long()]
    mat = torch.stack([p1, p2, p3], dim=-2)          # [B, 3, 3]
    denom = _det3(mat)

    def cramer(col):
        m = mat.clone()
        m[:, :, col] = 1.0
        return _det3(m)

    safe = torch.where(torch.abs(denom) > 0, denom, 1.0)
    abc = torch.stack([cramer(0), cramer(1), cramer(2)], dim=-1) / safe[:, None]
    planar = torch.abs(
        abc[:, None, 0] * pos[None, :, 0] + abc[:, None, 1] * pos[None, :, 1]
        + abc[:, None, 2] * pos[None, :, 2] - 1.0
    )
    planar = torch.where((torch.abs(denom) > 0)[:, None], planar, 1e4)
    d1 = _norm(pos[None, :, :] - p1[:, None, :])
    d2 = _norm(pos[None, :, :] - p2[:, None, :])
    d3 = _norm(pos[None, :, :] - p3[:, None, :])
    exists = _pairwise_exists(table, pos, normal, idx3, tr, rot, exists_bits)
    reject = (
        (planar > plane_threshold)
        | (d1 < min_distance_base)
        | (d2 < min_distance_base)
        | (d3 < min_distance_base)
        | ~exists
        | (arange_n == idx3[:, None])
    )
    return ~reject


def sample_class_bases(
    key: torch.Tensor,
    table: PPFTable,
    pos: torch.Tensor,        # [N, 3] centered scene positions
    normal: torch.Tensor,     # [N, 3]
    prior: torch.Tensor,      # [N] per-point prior (class probability)
    valid: torch.Tensor,      # [N] live-point mask
    num_bases: int,
    tr_disc: int,
    rot_disc: int,
    plane_threshold: float,
    min_distance_base: float,
    internal_angle_threshold: float,
    exists_bits=None,
) -> SampledBases:
    """The class-conditional path (no edge map): four rounds of conditional
    masking, batched over B bases."""
    n = pos.shape[0]
    k1, k2, k3, k4 = rng.split(key, 4)
    w = torch.where(valid, prior, 0.0)
    log_w = log_weights(w)                 # once for the four rounds
    probs = w.expand(num_bases, n)
    arange_n = torch.arange(n, dtype=torch.int32, device=pos.device)[None, :]
    # the four rounds' noise (rng.categorical under k1..k4) in one pass
    g = rng.gumbel_keys((k1, k2, k3, k4), probs.shape, pos.device)
    draw = _categorical_rows_with_noise

    idx1, ok1 = draw(g[0], probs, log_w)
    exists1 = _pairwise_exists(table, pos, normal, idx1, tr_disc, rot_disc,
                               exists_bits)
    probs = torch.where(exists1 & (arange_n != idx1[:, None]), probs, 0.0)

    idx2, ok2 = draw(g[1], probs, log_w)
    keep2 = round2_keep_mask(table, pos, normal, idx1, idx2, tr_disc,
                             rot_disc, internal_angle_threshold, exists_bits)
    probs = torch.where(keep2, probs, 0.0)

    idx3, ok3 = draw(g[2], probs, log_w)
    keep3 = round3_keep_mask(table, pos, normal, idx1, idx2, idx3, tr_disc,
                             rot_disc, plane_threshold, min_distance_base,
                             exists_bits)
    probs = torch.where(keep3, probs, 0.0)

    idx4, ok4 = draw(g[3], probs, log_w)

    raw = torch.stack([idx1, idx2, idx3, idx4], dim=-1)      # [B, 4]
    perm, inv1, inv2, _dist = invariants.reorder_base(pos[raw.long()])
    return SampledBases(
        indices=torch.gather(raw, -1, perm),
        invariant1=inv1,
        invariant2=inv2,
        valid=ok1 & ok2 & ok3 & ok4,
    )
