"""Multi-object matching: every object against one shared scene.

Counterpart of ``model_matching_tpu/multi.py``. All objects share one scene
geometry (the union of their probability supports: one back-projection,
one voxel filter, one grid and field, ``scene.load_scene_multi``) and
differ only in their probability vectors and model packs. As in the JAX
package, every model's PPF tables are rebuilt at common sizes and the
clouds padded to a common length (``align_models``), so every object runs
at the same shapes; where the JAX package stacks the aligned packs and maps
one compiled program over the object axis (``lax.map``, which runs the
objects one after another), the port loops over the aligned packs on the
device and reads all objects' outputs to the host once. With a `mesh`
(parallel/sharding.py) of D > 1 ranks the object axis is split into
contiguous blocks, one a rank, as the JAX package's shard_map does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from . import congruent, rng, sampling, scoring
from .config import MatchConfig
from .estimator import _ep_quad, _pair_ep_of, _phase_sample_instance, _to_host
from .model import ModelPack, build_pair_ep
from .ops import fit as fit_ops
from .ppf_table import resize_table
from .scene import ScenePack
from .utils import trace
from .utils.log import warn


def align_models(models: Sequence[ModelPack]) -> List[ModelPack]:
    """Rebuild the packs so every array shape matches across objects: each
    table at the largest sizes of the batch (direct-mapped twins at a
    common size, or dropped if any model lacks them), the clouds padded
    with zero rows to the longest, the endpoint rows rebuilt from the
    aligned (padded) pair array, the probe bounds equalized. The packs stay
    on their device, and the tables are rebuilt there."""
    exist = max(int(m.table.exist_keys.shape[0]) for m in models)
    bins = max(int(m.table.bin_keys.shape[0]) for m in models)
    pairs = max(int(m.table.pairs.shape[0]) for m in models)
    mcap = max(int(m.pos.shape[0]) for m in models)
    if any(m.table.bin_direct is None for m in models):
        direct = None
    else:
        direct = max(int(m.table.bin_direct.shape[0]) for m in models)

    out = []
    for m in models:
        t = resize_table(m.table, exist, bins, pairs, direct_size=direct)

        def pad(a):
            if a.shape[0] == mcap:
                return a
            return torch.cat([a, a.new_zeros((mcap - a.shape[0],) + a.shape[1:])])

        ppos = pad(m.pos)
        out.append(ModelPack(
            pos=ppos, normal=pad(m.normal), rgb=pad(m.rgb), valid=pad(m.valid),
            centroid=m.centroid, table=t, pair_ep=build_pair_ep(ppos, t.pairs),
        ))
    ep = max(m.table.exist_max_probes for m in out)
    bp = max(m.table.bin_max_probes for m in out)
    return [dataclasses.replace(m, table=dataclasses.replace(
        m.table, exist_max_probes=ep, bin_max_probes=bp)) for m in out]


def _match_one(model: ModelPack, scene: ScenePack, prior, okey,
               cfg: MatchConfig, d2_implied: bool):
    """One object's full match on the class path: its bases drawn from the
    scene points its prior covers, then phases 2-4."""
    k_sample, k_cong = rng.split(okey)
    bases = sampling.sample_class_bases(
        k_sample, model.table, scene.pos, scene.normal, prior,
        scene.valid & (prior > 0),
        num_bases=cfg.number_of_bases,
        tr_disc=cfg.ppf_tr_discretization,
        rot_disc=cfg.ppf_rot_discretization,
        plane_threshold=cfg.plane_threshold,
        min_distance_base=cfg.min_distance_base,
        internal_angle_threshold=cfg.internal_angle_threshold,
    )
    return _match_tail(model, scene, prior, k_cong, bases, cfg, d2_implied)


def _match_tail(model: ModelPack, scene: ScenePack, prior, k_cong,
                bases: sampling.SampledBases, cfg: MatchConfig,
                d2_implied: bool):
    """Phases 2-4 (congruent -> fit -> score) and the object's argmax for
    already-sampled bases. Every congruent slot is fitted (no fit-time
    compaction, as in the JAX package's multi-object program); `prior` is
    the object's sampling-time (possibly decayed) prior, read by the score.
    Returns 0-dim best LCP, the [4, 4] world pose, 0-dim valid count."""
    sets = congruent.extract_congruent_sets(
        k_cong, model.table, model.pos, scene.pos, scene.normal,
        bases.indices, bases.invariant1, bases.invariant2, bases.valid, cfg,
        pair_ep=model.pair_ep, d2_implied=d2_implied,
    )
    b, k, _ = sets.pairs.shape
    scene_quad = scene.pos[bases.indices.long()][:, None].expand(b, k, 4, 3)
    fits = fit_ops.fit_congruent_pairs(scene_quad, _ep_quad(_pair_ep_of(model), sets.pairs),
                                       scene.centroid, model.centroid)
    valid = (fits["valid"] & sets.quad_valid & bases.valid[:, None]).reshape(-1)
    scores = scoring.score_hybrid(
        fits["transform"].reshape(-1, 4, 4), valid,
        model.pos, model.normal, model.valid,
        scene.field, scene.grid, scene.pos, scene.normal, prior,
        cfg.distance_threshold, cfg.lcp_normal_angle_threshold,
        model_count=model.valid.to(torch.float32).sum(),
        compact_cap=cfg.score_compact_cap, mid_cap=cfg.score_mid_cap,
    )
    idx, best = scoring.best_pose(scores)
    pose = fits["world_transform"].reshape(-1, 4, 4)[torch.clamp(idx, min=0).long()]
    return best, pose, valid.sum(dtype=torch.int32)


def match_all_objects(models: Sequence[ModelPack], scene: ScenePack, probs,
                      cfg: MatchConfig, seed: int = 0, mesh=None):
    """Every object of `models` against `scene`, with `probs` [O, P] the
    per-object probability vectors. Returns numpy (best_lcp [O] float32,
    best_world_transform [O, 4, 4] float32, hypotheses [O] int32); an
    object whose best LCP is 0 found no pose.

    Object o draws from fold_in(PRNGKey(seed), o), split into its sampling
    and congruent keys. An edge-mapped scene runs the instance path per
    object: each object's sequential flood-fill chain samples on its own
    ORIGINAL table under its own prior (decaying it), phases 2-4 run on the
    aligned pack, and the score reads that object's decayed prior. An
    object's result depends only on its own pack, prior and index, given
    the aligned shapes (as in the JAX package, those are the batch's
    largest: the cloud length sets the stride of the scoring ladder's
    coarse stage), so zeroing another object's prior leaves it unchanged.
    The outputs, the count of unconverged flood fills and the hypothesis
    counts for the score_compact_cap warning come to the host in one
    transfer.

    `mesh` (parallel.sharding.Mesh) with D > 1 ranks: the objects, padded
    to a multiple of D with zero-probability replicas of the last one
    (whose bases all fail; on the instance path they are the last object's
    bases marked invalid), are split into D contiguous blocks; each rank
    matches its block on its own device, the results are gathered
    rank-major and the padding dropped. The keys stay fold_in(PRNGKey(seed),
    o), so the result equals the one without a mesh bit for bit.

    Spans: `multi.match` around the call, with `multi.align` (align_models
    and the distance-test check on the aligned packs), one `multi.object`
    an object slot and `multi.read` (the one transfer and its checks)."""
    with trace.span("multi.match"):
        return _match_all(models, scene, probs, cfg, seed, mesh)


def _match_all(models, scene, probs, cfg, seed, mesh):
    with trace.span("multi.align"):
        aligned = align_models(models)
        d2 = congruent.d2_test_implied(torch.stack([m.pos for m in aligned]), cfg)
    dev = scene.pos.device
    key = rng.PRNGKey(seed)
    n_obj = len(models)
    okeys = [rng.fold_in(key, o) for o in range(n_obj)]
    probs = torch.as_tensor(probs, dtype=torch.float32).to(dev)
    sampled = {}

    def sample(o):
        """Object o's instance bases and decayed prior, drawn once."""
        if o not in sampled:
            k_sample, k_cong = rng.split(okeys[o])
            sampled[o] = (_phase_sample_instance(
                k_sample, models[o].table, scene, probs[o], cfg,
                cfg.number_of_bases), k_cong)
        return sampled[o]

    def match(o, model, sc):
        """Object slot o on the device of `model` and `sc`: (best, pose,
        valid count, unconverged fills); a slot past the last object is a
        zero-probability replica of it."""
        with trace.span("multi.object"):
            d = sc.pos.device
            real = o < n_obj
            last = min(o, n_obj - 1)
            zero = torch.zeros((), dtype=torch.int32, device=d)
            prior = probs[o].to(d) if real else torch.zeros_like(probs[0], device=d)
            if not scene.has_edge:
                return _match_one(model, sc, prior, okeys[last], cfg, d2) + (zero,)
            inst, k_cong = sample(last)
            valid = inst.valid if real else torch.zeros_like(inst.valid)
            bases = sampling.SampledBases(inst.indices.to(d), inst.invariant1.to(d),
                                          inst.invariant2.to(d), valid.to(d))
            unconv = (~inst.fill_converged).sum(dtype=torch.int32).to(d) if real else zero
            return _match_tail(model, sc, inst.class_prob.to(d) if real else prior,
                               k_cong, bases, cfg, d2) + (unconv,)

    if mesh is None or mesh.size == 1:
        outs = [match(o, m, scene) for o, m in enumerate(aligned)]
        best, poses, nhyp, unconv = (torch.stack(x) for x in zip(*outs))
    else:
        from .parallel.sharding import _all_gather, _flat, _on_ranks

        per = -(-n_obj // mesh.size)
        parts = []
        for i, (sc,) in enumerate(_on_ranks(mesh, scene)):
            block = range(mesh.rank(i) * per, (mesh.rank(i) + 1) * per)
            outs = [match(o, aligned[min(o, n_obj - 1)].to(sc.pos.device), sc)
                    for o in block]
            parts.append(_flat(*(torch.stack(x) for x in zip(*outs))))
        g = _all_gather(mesh, parts, dev)                 # [D, per * 19]
        best = g[:, :per].reshape(-1)[:n_obj].to(torch.float32)
        poses = g[:, per:17 * per].reshape(-1, 4, 4)[:n_obj].to(torch.float32)
        nhyp = g[:, 17 * per:18 * per].reshape(-1)[:n_obj].to(torch.int32)
        unconv = g[:, 18 * per:].reshape(-1)[:n_obj].to(torch.int32)
    with trace.span("multi.read"):
        best, poses, nhyp, n_unconv = _to_host(best, poses, nhyp, unconv.sum())
        if int(n_unconv):
            warn(
                f"{int(n_unconv)} flood fills across the multi-object batch did "
                f"not reach their BFS fixpoint in flood_fill_sweeps="
                f"{cfg.flood_fill_sweeps} sweeps — segments under-fill",
                n_unconverged=int(n_unconv), sweeps=cfg.flood_fill_sweeps,
            )
        # score_hybrid scores only the first score_compact_cap valid
        # hypotheses of an object and drops the rest
        cap = cfg.score_compact_cap
        slots = cfg.number_of_bases * cfg.maximum_congruent_sets
        if cap and slots > cap and int(nhyp.max()) > cap:
            warn(
                f"an object produced {int(nhyp.max())} valid hypotheses, over "
                f"score_compact_cap={cap}; overflow was not scored — raise "
                f"the cap for full recall",
                n_valid=int(nhyp.max()), cap=cap,
            )
    return best.astype(np.float32), poses.astype(np.float32), nhyp.astype(np.int32)
