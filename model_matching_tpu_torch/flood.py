"""Edge-bounded flood-fill segmentation as iterated sweep propagation.

Counterpart of ``model_matching_tpu/flood.py``. A segment grows from a seed
pixel over the 8-connected free-space pixels within a euclidean pixel
radius of the seed. A queue does not vectorize, so each sweep combines

  * one 8-connected dilation step (diagonal connectivity; it also lifts a
    blocked seed onto its free neighbours), and
  * full row and column reach: within every unblocked run of a row (then
    column) one marked pixel marks the whole run, by the "last marked index
    > last blocked index" comparison of two running maxima per direction.

The fixpoint equals 8-connected BFS reachability and is reached in
O(bends of the region) sweeps. Every function takes a leading batch axis:
[K, 2] seeds, [K] radii, [K, H, W] masks over one shared [H, W] edge map
(the blocked sampler fills a block of seeds at once; one seed is K = 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops.fp import sqrt_rn
from .utils import trace


def _dilate8(mask):
    """8-connected binary dilation of [..., H, W] bool masks (zero padding
    at the image border): a 3x3 maximum."""
    m = mask.reshape((-1, 1) + mask.shape[-2:]).to(torch.float32)
    return (F.max_pool2d(m, 3, stride=1, padding=1) > 0).reshape(mask.shape)


def _running_last(flags, axis):
    """Index of the last set flag at or before each position along `axis`
    (-1 when none): a running maximum of the flagged positions."""
    pos = torch.arange(flags.shape[axis], dtype=torch.int32, device=flags.device)
    shape = [1] * flags.dim()
    shape[axis] = -1
    marked = torch.where(flags, pos.reshape(shape), -1)
    return torch.cummax(marked, dim=axis).values


def _both_ways(x, axis):
    """Stack a tensor with its flip along `axis`: the backward reach is the
    forward reach of the flipped line (torch's cummax has no reverse)."""
    return torch.stack([x, torch.flip(x, dims=(axis,))])


def _last_block(allowed, axis):
    """The blocked-cell half of `_axis_reach`, which does not change while
    a fill sweeps: [2, ..., H, W] running last-blocked indices, forward
    and on the flipped line."""
    return _running_last(_both_ways(~allowed, axis), axis + 1)


def _axis_reach(mask, allowed, axis, last_block=None):
    """Pixels reachable from a marked pixel along `axis` (-2 rows, -1
    columns) without crossing a blocked cell, in both directions."""
    axis = axis % mask.dim()
    if last_block is None:
        last_block = _last_block(allowed, axis)
    reach = _running_last(_both_ways(mask, axis), axis + 1) > last_block
    return allowed & (reach[0] | torch.flip(reach[1], dims=(axis,)))


def _allowed_and_seed(seed_rc, edge_free, max_pixel_distance):
    """([K, H, W] pixels the fill may enter, [K, H, W] one-hot seed masks).
    The distance test is a strict comparison of a float32 square root, so
    the root is the correctly rounded one on every device."""
    h, w = edge_free.shape
    dev = edge_free.device
    seed_rc = seed_rc.reshape(-1, 2)
    k = seed_rc.shape[0]
    rows = torch.arange(h, dtype=torch.int32, device=dev)[None, :, None]
    cols = torch.arange(w, dtype=torch.int32, device=dev)[None, None, :]
    dr = (rows - seed_rc[:, 0, None, None]).to(torch.float32)
    dc = (cols - seed_rc[:, 1, None, None]).to(torch.float32)
    dist = sqrt_rn(dr * dr + dc * dc)
    radius = torch.as_tensor(max_pixel_distance, dtype=torch.float32,
                             device=dev).reshape(-1, 1, 1)
    allowed = edge_free[None] & (dist < radius)
    seed = ((rows == seed_rc[:, 0, None, None])
            & (cols == seed_rc[:, 1, None, None])).expand(k, h, w)
    return allowed, seed


def flood_fill(seed_rc, edge_free, max_pixel_distance, max_iters: int = 512,
               fixed_sweeps: int | None = None,
               return_converged: bool = False):
    """Boolean segment masks [K, H, W] for [K, 2] int32 (row, col) seeds
    ([H, W] for one [2] seed), over the [H, W] bool `edge_free` map, within
    the scalar or [K] radius `max_pixel_distance`. The seed pixel is always
    in its mask, free or not; other pixels must be free space and strictly
    within the radius.

    fixed_sweeps=None sweeps until nothing changes (at most `max_iters`
    sweeps; one host read per sweep). fixed_sweeps=k runs exactly k sweeps
    with no host read: the sweep is monotone and idempotent at the
    fixpoint, so any k at or above the convergence count gives the exact
    reachability.

    return_converged=True also returns [K] bool (a 0-dim bool for one
    seed): with fixed sweeps, whether one more sweep changes nothing; in
    the loop, whether the last sweep made no change or the loop ended
    before `max_iters`."""
    single = seed_rc.dim() == 1
    allowed, mask = _allowed_and_seed(seed_rc, edge_free, max_pixel_distance)
    blocks = (_last_block(allowed, 1), _last_block(allowed, 2))

    def sweep(m):
        new = m | (_dilate8(m) & allowed)
        new = new | _axis_reach(new, allowed, 1, blocks[0])
        return new | _axis_reach(new, allowed, 2, blocks[1])

    if fixed_sweeps is not None:
        for _ in range(fixed_sweeps):
            mask = sweep(mask)
        converged = None
        if return_converged:
            converged = (sweep(mask) == mask).flatten(1).all(dim=1)
    else:
        k = mask.shape[0]
        changed = torch.ones(k, dtype=torch.bool, device=mask.device)
        iters = torch.zeros(k, dtype=torch.int32, device=mask.device)
        while True:
            active = changed & (iters < max_iters)
            trace.count("host_reads")
            if not bool(active.any()):                   # host read
                break
            new = torch.where(active[:, None, None], sweep(mask), mask)
            changed = torch.where(active, (new != mask).flatten(1).any(dim=1),
                                  changed)
            iters = iters + active.to(torch.int32)
            mask = new
        converged = ~changed | (iters < max_iters)
    if single:
        mask = mask[0]
        converged = converged[0] if converged is not None else None
    return (mask, converged) if return_converged else mask


def local_flood_fill(seed_rc, edge_free, max_pixel_distance,
                     depth_limit: int = 100):
    """The fill additionally bounded by graph depth: the 8-connected
    geodesic ball of radius depth_limit - 1 around the seed. One masked
    dilation applies exactly one BFS layer, so the ball is depth_limit - 1
    dilations (stopping early once nothing changes: one host read a
    layer)."""
    single = seed_rc.dim() == 1
    allowed, mask = _allowed_and_seed(seed_rc, edge_free, max_pixel_distance)
    for _ in range(depth_limit - 1):
        new = mask | (_dilate8(mask) & allowed)
        if torch.equal(new, mask):
            break
        mask = new
    return mask[0] if single else mask


def prune_edge_points(probs, edge_prob):
    """Zero the sampling probability of points sitting exactly on an edge
    (edge probability == 1)."""
    return torch.where(edge_prob == 1.0, 0.0, probs)


def segment_edge_max_probability(seg_mask, edge_prob_img, rc_a, rc_b):
    """Max edge probability along the raster line between two pixels (a
    fixed 256-sample DDA). `seg_mask` is unused, as in the JAX package."""
    t = torch.linspace(0.0, 1.0, 256, device=edge_prob_img.device)
    a = rc_a.to(torch.float32)
    b = rc_b.to(torch.float32)
    h, w = edge_prob_img.shape
    rr = torch.round(a[0] + t * (b[0] - a[0])).long().clamp(0, h - 1)
    cc = torch.round(a[1] + t * (b[1] - a[1])).long().clamp(0, w - 1)
    return edge_prob_img[rr, cc].max()
