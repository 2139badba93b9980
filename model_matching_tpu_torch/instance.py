"""Instance-conditional base sampling: the edge-aware sequential path.

Counterpart of ``model_matching_tpu/instance.py``. It differs from the
class path by (a) decaying the class probability of points inside the
previous base's segment by `dispersion`, a cross-base mutation that also
changes the LCP weights scoring reads later; (b) pruning points on edges;
(c) flood-filling a segmentation mask around point 1 (bounded by the edge
map and the largest PPF-feasible pixel distance) and restricting the
remaining rounds to it, with a cross-base cache of masks keyed by seed
pixel (a [B + 1, H, W] buffer, written row by row in place).

The cross-base dependence makes the path sequential: one Python loop over
bases with the decayed probabilities, the previous segment, the claim
buffer and the mask cache as state, on the card hand-written kernels for
each of a base's two parts around the fill (ops/base_rounds), replayed
as CUDA graphs base after base. PyTorch compiles no trace, so the JAX
package's whole-scan sampler and its host-driven stepper are one loop
here (``sample_instance_bases`` and ``sample_instance_bases_stepwise``
give the same outputs); the Gumbel noise of a block of bases is made in
one batch. ``sample_instance_bases_blocked`` is the block-parallel variant
with its documented divergences.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import flood, rng, sampling
from .ops import base_rounds, fmath, invariants
from .ops.base_rounds import pixel_distance
from .ppf_table import PPFTable
from .utils import trace


class InstanceSamples(NamedTuple):
    indices: torch.Tensor      # [B, 4] reordered base indices
    invariant1: torch.Tensor   # [B]
    invariant2: torch.Tensor   # [B]
    valid: torch.Tensor        # [B]
    class_prob: torch.Tensor   # [N] final decayed class probabilities
    seg_masks: torch.Tensor    # [B+1, H, W] bool — per-base segments (0 unused)
    fill_converged: torch.Tensor  # [B] bool — flood fill reached its fixpoint
                                  # (False = flood_fill_sweeps too small)


# one categorical draw per row of [K, N] weights with that row's own noise
_draw_rows = sampling._categorical_rows_with_noise


def _base_keys(key, num_bases):
    """[B, 4, 2] round keys: split(key, B), each split in 4."""
    return rng.split(rng.split(key, num_bases), 4)


def _finish(pos, raws, oks, class_prob, masks, fills) -> InstanceSamples:
    # the JAX package reorders these bases op by op, outside any compiled
    # program: uncontracted rounding picks its ordering among the ties
    perm, inv1, inv2, _d = invariants.reorder_base(pos[raws.long()],
                                                   contracted=False)
    return InstanceSamples(
        indices=torch.gather(raws, -1, perm), invariant1=inv1,
        invariant2=inv2, valid=oks, class_prob=class_prob, seg_masks=masks,
        fill_converged=fills,
    )


@functools.lru_cache(maxsize=None)
def _capture_resources(device: str):
    """(side stream, pool, anchor graph) for a device's CUDA graphs, made
    once per device. The allocator reuses a pool's free blocks only on the
    stream that made them, so every capture runs on this one stream. It
    frees a pool that no graph holds only on an empty_cache or a failed
    allocation, so a pool a call would pile up; the anchor, a one-kernel
    graph kept here, holds this one, and each call's captures reuse the
    blocks the last call's freed."""
    with torch.cuda.device(device):
        stream, pool = torch.cuda.Stream(), torch.cuda.graph_pool_handle()
        anchor = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            anchor.capture_begin(pool=pool)
            try:
                torch.zeros(1, device=device)
            finally:
                anchor.capture_end()
    return stream, pool, anchor


class _Graphs:
    """CUDA graphs of the given parts of a base, captured in order on the
    device's side stream into one shared pool, so a later part reads the
    outputs an earlier one leaves there; replayed on the current stream.
    The graphs go with this object, and their blocks back to the pool."""

    def __init__(self, dev, parts):
        stream, pool, _anchor = _capture_resources(str(dev))
        current = torch.cuda.current_stream(dev)
        self._graphs = {}
        stream.wait_stream(current)
        # capture_begin rather than the torch.cuda.graph context, whose
        # entry empties the allocator's cache at every capture
        with torch.cuda.stream(stream):
            for name, fn in parts.items():
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=pool)
                try:
                    fn()
                finally:
                    graph.capture_end()
                self._graphs[name] = graph
                trace.count("instance.graph_captures")
        current.wait_stream(stream)

    def __call__(self, name):
        self._graphs[name].replay()


def sample_instance_bases_stepwise(
    key: torch.Tensor,
    table: PPFTable,
    pos, normal, class_prob0, edge_prob, pixel, valid, edge_free,
    num_bases: int,
    dispersion: float,
    tr_disc: int,
    rot_disc: int,
    plane_threshold: float,
    min_distance_base: float,
    internal_angle_threshold: float,
    flood_max_iters: int = 512,
    block: int = 10,
    exists_bits=None,
    flood_sweeps=None,
) -> InstanceSamples:
    """The sequential sampler. `block` is the number of bases whose Gumbel
    noise is generated at once ([block * 4, N] floats); it changes no
    output. The JAX package's stepper pads the last block with inert steps;
    this loop runs none.

    A base whose seed pixel was claimed by an earlier base reuses that
    base's cached mask; otherwise it flood-fills. The loop reads the claim
    on the host to take that branch: one device sync a base, and a fill
    only when needed.

    A base runs in parts (`pre`: the decay, round 1, its segment's radius
    and the claim; the fill; `post`: rounds 2-4 and the output rows) that
    update state allocated once (ops/base_rounds.Rounds), the base number
    included, in place and without a host read. On a CUDA device `pre` and
    `post` are each one launch of ops/base_rounds' kernels, bit-equal to
    their plain torch versions, which the CPU runs. With fixed flood sweeps
    every base after the first replays CUDA graphs of the parts, captured
    once a call after the first base has run them eagerly and made the
    constants they read: the same kernels, so the same bits, at a fraction
    of the launch cost. A fill that sweeps to its fixpoint reads the host
    every sweep, so without fixed sweeps every base runs eagerly."""
    dev = pos.device
    n = pos.shape[0]
    s = base_rounds.Rounds(
        table, pos, normal, class_prob0, edge_prob, pixel, valid, edge_free.shape,
        num_bases, block, dispersion, tr_disc, rot_disc, plane_threshold,
        min_distance_base, internal_angle_threshold, exists_bits)

    def fill():                                 # the seed unclaimed
        m, conv = flood.flood_fill(
            s.seed_rc, edge_free, s.max_pix_dist, max_iters=flood_max_iters,
            fixed_sweeps=flood_sweeps, return_converged=True)
        m = m[0]
        s.seg.copy_(m)
        s.fill_ok.copy_(conv)
        s.seg_buffer.copy_(torch.where(m, (s.row + 1).to(torch.int32), s.seg_buffer))

    # looked up at each call, so that a test can swap in the plain parts
    parts = dict(pre=lambda: base_rounds.base_pre(s), fill=fill,
                 post=lambda: base_rounds.base_post(s))
    capture = dev.type == "cuda" and flood_sweeps is not None and num_bases > 1

    def run(name):                              # eagerly, until captured
        parts[name]()

    keys = _base_keys(key, num_bases)
    graphs = None
    for b in range(num_bases):
        if b % block == 0:
            block_noise = rng.gumbel_rows(keys[b:b + block].reshape(-1, 2), n, dev)
            s.noise[:block_noise.shape[0] // 4].copy_(block_noise.reshape(-1, 4, 1, n))
        if b == 1 and capture:
            run = graphs = _Graphs(dev, parts)
        if graphs is not None:
            trace.count("instance.graph_replays")
            base_rounds.count_replay(s)
        run("pre")
        # segmentation mask: the cached segment if the seed pixel was
        # claimed by an earlier base, else a flood fill
        trace.count("host_reads")
        hit = int(s.cached_id)                               # host read
        if hit:
            s.seg.copy_(s.masks[hit])
            s.fill_ok.fill_(True)
        else:
            trace.count("instance.flood_fills")
            run("fill")
        run("post")
    return _finish(pos, s.raws, s.oks, s.class_prob, s.masks, s.fills)


def sample_instance_bases(
    key: torch.Tensor,
    table: PPFTable,
    pos: torch.Tensor,          # [N, 3] centered scene positions
    normal: torch.Tensor,       # [N, 3]
    class_prob0: torch.Tensor,  # [N] initial class probabilities
    edge_prob: torch.Tensor,    # [N] per-point edge probability
    pixel: torch.Tensor,        # [N, 2] (row, col) source pixels
    valid: torch.Tensor,        # [N]
    edge_free: torch.Tensor,    # [H, W] bool — flood fill may enter
    num_bases: int,
    dispersion: float,
    tr_disc: int,
    rot_disc: int,
    plane_threshold: float,
    min_distance_base: float,
    internal_angle_threshold: float,
    flood_max_iters: int = 512,
    exists_bits=None,
    flood_sweeps=None,
) -> InstanceSamples:
    """The JAX package's whole-scan sampler: the same loop as
    sample_instance_bases_stepwise."""
    return sample_instance_bases_stepwise(
        key, table, pos, normal, class_prob0, edge_prob, pixel, valid,
        edge_free, num_bases, dispersion, tr_disc, rot_disc, plane_threshold,
        min_distance_base, internal_angle_threshold,
        flood_max_iters=flood_max_iters, block=64, exists_bits=exists_bits,
        flood_sweeps=flood_sweeps,
    )


def sample_instance_bases_blocked(
    key: torch.Tensor,
    table: PPFTable,
    pos, normal, class_prob0, edge_prob, pixel, valid, edge_free,
    num_bases: int,
    dispersion: float,
    tr_disc: int,
    rot_disc: int,
    plane_threshold: float,
    min_distance_base: float,
    internal_angle_threshold: float,
    flood_max_iters: int = 512,
    block_size: int = 8,
    exists_bits=None,
    flood_sweeps=None,
) -> InstanceSamples:
    """Block-parallel variant: `block_size` bases are sampled at once —
    round-1 draws in parallel from the same prior, flood fills batched as
    one [K, H, W] program, rounds 2-4 as [K, N] masked draws — and the
    dispersion decay is applied once per block (dispersion ** count of the
    block's segments covering each point).

    Documented divergences from the sequential sampler: (a) bases within
    one block do not see each other's decay, so intra-block draws repel
    less than the sequential chain (the cumulative decay exponent over a
    full run is the same: segments of bases 1..B-1 each decay once); (b)
    the seed-pixel mask cache is skipped: when a seed lands inside an
    earlier base's claimed segment the sequential path substitutes that
    base's mask, while this path always fills fresh from the current seed.
    With dispersion == 1.0 and no divergent cache hit the draws match the
    sequential sampler exactly (per-base keys are derived identically).
    The last block is padded with inert steps that reuse the last key."""
    dev = pos.device
    h, w = edge_free.shape
    n = pos.shape[0]
    k_block = block_size
    arange_n = torch.arange(n, dtype=torch.int32, device=dev)
    disp = torch.tensor(dispersion, dtype=torch.float32, device=dev)
    prow, pcol = pixel[:, 0].long(), pixel[:, 1].long()

    nb = -(-num_bases // k_block)
    total = nb * k_block
    keys = _base_keys(key, num_bases)
    if total > num_bases:
        keys = torch.cat([keys, keys[-1:].expand(total - num_bases, 4, 2)])
    steps = torch.arange(total, device=dev)
    # the last real base's segment never decays anyone (sequential parity)
    decays = steps < num_bases - 1

    class_prob = class_prob0.clone()
    raws, oks, fills = [], [], []
    masks_out = [torch.zeros((1, h, w), dtype=torch.bool, device=dev)]
    for i in range(nb):
        blk = slice(i * k_block, (i + 1) * k_block)
        g = rng.gumbel_rows(keys[blk].reshape(-1, 2), n, dev).reshape(k_block, 4, n)

        probs0 = torch.where(valid, class_prob, 0.0)
        probs0 = flood.prune_edge_points(probs0, edge_prob)
        log_w = sampling.log_weights(probs0)     # once for the block's draws
        probs0 = probs0.expand(k_block, n)

        idx1, ok1 = _draw_rows(g[:, 0], probs0, log_w)
        exists1 = sampling._pairwise_exists(
            table, pos, normal, idx1, tr_disc, rot_disc, exists_bits)
        probs = torch.where(exists1 & (arange_n[None, :] != idx1[:, None]),
                            probs0, 0.0)
        seed_rc = pixel[idx1.long()]                          # [K, 2]
        pix_d = pixel_distance(pixel, seed_rc)
        max_pix_dist = torch.where(probs > 0, pix_d, 0.0).amax(dim=1)

        trace.count("instance.flood_fills", k_block)
        masks, fill_ok = flood.flood_fill(
            seed_rc, edge_free, max_pix_dist, max_iters=flood_max_iters,
            fixed_sweeps=flood_sweeps, return_converged=True)   # [K, H, W]

        in_seg = masks[:, prow, pcol]                           # [K, N]
        probs = torch.where(in_seg, probs, 0.0)

        idx2, ok2 = _draw_rows(g[:, 1], probs, log_w)
        probs = torch.where(sampling.round2_keep_mask(
            table, pos, normal, idx1, idx2, tr_disc, rot_disc,
            internal_angle_threshold, exists_bits), probs, 0.0)
        idx3, ok3 = _draw_rows(g[:, 2], probs, log_w)
        probs = torch.where(sampling.round3_keep_mask(
            table, pos, normal, idx1, idx2, idx3, tr_disc, rot_disc,
            plane_threshold, min_distance_base, exists_bits), probs, 0.0)
        idx4, ok4 = _draw_rows(g[:, 3], probs, log_w)

        # block-boundary decay: a base's segment decays the prior once,
        # when the sequential chain would (at the start of the following
        # base); padding steps have no follower either
        counts = (in_seg & decays[blk, None]).to(torch.float32).sum(dim=0)
        class_prob = torch.where(valid, class_prob * fmath.pow(disp, counts),
                                 class_prob)
        raws.append(torch.stack([idx1, idx2, idx3, idx4], dim=1))
        oks.append(ok1 & ok2 & ok3 & ok4)
        fills.append(fill_ok)
        masks_out.append(masks)
    return _finish(
        pos, torch.cat(raws)[:num_bases], torch.cat(oks)[:num_bases],
        class_prob, torch.cat(masks_out)[:num_bases + 1],
        torch.cat(fills)[:num_bases],
    )
