"""4-point base invariants: segment-segment closest points and reordering.

Counterpart of ``model_matching_tpu/ops/invariants.py``: the branch-free
clamped segment/segment solve that defines the 4PCS invariants, and the
12-permutation reordering that picks the crossing with the smallest
segment distance. Batched over leading dims.

The 12 orderings come in groups with mathematically equal segment
distances, so the last ULP decides which one wins: the arithmetic follows
the JAX package's contracted rounding (ops/fp.py) to pick its ordering.
The JAX package's instance sampler reorders its bases outside any compiled
program, op by op, where nothing is contracted across ops:
`contracted=False` rounds every product and sum on its own, as that path
does (only the final norm, one compiled unit there too, stays a fused
chain). The two modes can pick different orderings of the same four points.
"""

from __future__ import annotations

import numpy as np
import torch

from .fp import dot3, fma, sqrt_rn

_EPS = 1e-4


def _sum3(x, y):
    """Sum over the last axis (size 3) of x * y, every product and sum
    rounded to float32 on its own, left to right."""
    p = x * y
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def segment_invariants(p1, p2, q1, q2, contracted: bool = True):
    """Closest points between segments [p1,p2] and [q1,q2]. Returns
    (distance, invariant1, invariant2), the invariants being the clamped
    parametric positions of the closest points, snapped to 0 below 1e-4."""
    u = p2 - p1
    v = q2 - q1
    w = p1 - q1
    dot = dot3 if contracted else _sum3
    a = dot(u, u)
    b = dot(u, v)
    c = dot(v, v)
    d = dot(u, w)
    e = dot(v, w)
    if contracted:
        f = fma(a, c, -(b * b))
        s1_raw = fma(b, e, -(c * d))
        t1_raw = fma(a, e, -(b * d))
    else:
        f = a * c - b * b
        s1_raw = b * e - c * d
        t1_raw = a * e - b * d

    parallel = f < _EPS
    s_neg = ~parallel & (s1_raw < 0.0)
    s_big = ~parallel & (s1_raw >= 0.0) & (s1_raw > f)

    zero = torch.zeros_like(f)
    one = torch.ones_like(f)
    s1 = torch.where(parallel, zero,
                     torch.where(s_neg, zero, torch.where(s_big, f, s1_raw)))
    s2 = torch.where(parallel, one, f)
    t1 = torch.where(parallel | s_neg, e, torch.where(s_big, e + b, t1_raw))
    t2 = torch.where(parallel | s_neg | s_big, c, f)

    # clamp t into [0, t2], adjusting s accordingly
    t_neg = t1 < 0.0
    t_big = ~t_neg & (t1 > t2)

    def clamp_s(dval, s1_in, s2_in):
        lo = dval < 0.0
        hi = dval > a
        s1o = torch.where(lo, zero, torch.where(hi, s2_in, dval))
        s2o = torch.where(lo | hi, s2_in, a)
        return s1o, s2o

    s1_tn, s2_tn = clamp_s(-d, s1, s2)
    s1_tb, s2_tb = clamp_s(-d + b, s1, s2)

    t1 = torch.where(t_neg, zero, torch.where(t_big, t2, t1))
    s1 = torch.where(t_neg, s1_tn, torch.where(t_big, s1_tb, s1))
    s2 = torch.where(t_neg, s2_tn, torch.where(t_big, s2_tb, s2))

    inv1 = torch.where(torch.abs(s1) < _EPS, zero, s1 / s2)
    inv2 = torch.where(torch.abs(t1) < _EPS, zero, t1 / t2)
    if contracted:
        r = fma(-inv2[..., None], v, fma(inv1[..., None], u, w))
    else:
        r = (w + inv1[..., None] * u) - inv2[..., None] * v
    # jnp.linalg.norm is one compiled unit even op by op: contracted
    return sqrt_rn(dot3(r, r)), inv1, inv2


def _permutations_4() -> np.ndarray:
    """The reference's 12 ordered (i, j) pairs with deterministic (k, l)
    completion (k = smallest index not in {i,j}, l = next)."""
    perms = []
    for i in range(4):
        for j in range(4):
            if i == j:
                continue
            k = 0
            while k in (i, j):
                k += 1
            l = 0
            while l in (i, j, k):
                l += 1
            perms.append((i, j, k, l))
    return np.array(perms, dtype=np.int64)  # [12, 4]


_PERMS = _permutations_4()


def reorder_base(base_pos: torch.Tensor, contracted: bool = True):
    """Reorder 4-point bases [..., 4, 3] to the permutation whose segments
    cross closest. Returns (perm [..., 4] — indices into the input order,
    invariant1 [...], invariant2 [...], min_distance [...])."""
    perms = torch.from_numpy(_PERMS).to(base_pos.device)
    cand = base_pos[..., perms, :]                 # [..., 12, 4, 3]
    dist, inv1, inv2 = segment_invariants(
        cand[..., 0, :], cand[..., 1, :], cand[..., 2, :], cand[..., 3, :],
        contracted=contracted,
    )
    # first minimum, like the reference's strict-less scan
    best = torch.argmin(dist, dim=-1)
    take = lambda x: torch.gather(x, -1, best[..., None])[..., 0]
    return perms[best], take(inv1), take(inv2), take(dist)
