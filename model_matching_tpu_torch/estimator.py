"""The STOCS estimator: four device phases and an ICP polish.

Counterpart of ``model_matching_tpu/estimator.py`` (``run``, ``run_sweep``
with its checkpoints, ``cluster_poses``):

  phase 1  sample B bases           (sampling.py, one [B, N] program; on a
                                     scene with an edge map instance.py, a
                                     sequential loop of flood-fill segments
                                     under a decaying prior)
  phase 2  congruent sets per base  (congruent.py, tier buckets; the dense
                                     tiers run the dense-gate kernel)
  phase 3  rigid fits               (ops/fit.py, one [B, K] batch)
  phase 4  weighted-LCP scores      (scoring.py, coarse-to-fine ladder)
  then     ICP refinement of the winner (icp.py)

Every phase runs on the device of the packs (nothing moves them), each is
a span of ``utils/trace`` (``estimate.*``; the first four end on a device
synchronize) whose wall time is reported in ``timings``, and host reads are
grouped into one transfer per decision point. The instance path leaves its
decayed prior on the estimator, and scoring reads it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from . import clustering, congruent, icp, instance, rng, sampling, scoring
from .config import MatchConfig
from .model import ModelPack, build_pair_ep
from .ops import fit as fit_ops
from .scene import ScenePack
from .types import PoseCandidates
from .utils import trace
from .utils.log import log_event, warn


@dataclasses.dataclass
class StocsResult:
    poses: PoseCandidates          # all hypotheses (padded, validity-masked)
    best_index: int                # -1 if no pose found
    best_lcp: float
    best_transform: Optional[np.ndarray]        # centered-frame 4x4
    best_world_transform: Optional[np.ndarray]  # original-frame 4x4
    num_bases: int
    num_hypotheses: int
    timings: dict                  # seconds per phase
    stats: dict


def _to_host(*tensors):
    """One device->host transfer for a group of values: each is flattened
    into one float64 vector (exact for int32 and float32) and split back.
    Returns numpy arrays in the input shapes. Counts one `host_reads` and
    the bytes read as `host_read_bytes`."""
    trace.count("host_reads")
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    trace.count("host_read_bytes", flat.nbytes)
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[i:i + n].reshape(tuple(t.shape)))
        i += n
    return out


def _phase_sample(key, table, pos, normal, prior, valid, cfg: MatchConfig,
                  num_bases: int, exists_bits=None):
    return sampling.sample_class_bases(
        key, table, pos, normal, prior, valid,
        num_bases=num_bases,
        tr_disc=cfg.ppf_tr_discretization,
        rot_disc=cfg.ppf_rot_discretization,
        plane_threshold=cfg.plane_threshold,
        min_distance_base=cfg.min_distance_base,
        internal_angle_threshold=cfg.internal_angle_threshold,
        exists_bits=exists_bits,
    )


def _phase_sample_instance(key, table, scene: ScenePack, class_prob,
                           cfg: MatchConfig, num_bases: int,
                           exists_bits=None):
    """Instance-conditional sampling: the block-parallel sampler when
    cfg.instance_block_size > 1 (its documented divergences, instance.py),
    else the sequential one, making cfg.instance_scan_block bases' noise at
    a time."""
    kwargs = dict(
        num_bases=num_bases,
        dispersion=cfg.sample_dispersion,
        tr_disc=cfg.ppf_tr_discretization,
        rot_disc=cfg.ppf_rot_discretization,
        plane_threshold=cfg.plane_threshold,
        min_distance_base=cfg.min_distance_base,
        internal_angle_threshold=cfg.internal_angle_threshold,
        flood_max_iters=cfg.flood_fill_max_iters,
        exists_bits=exists_bits,
        flood_sweeps=cfg.flood_fill_sweeps or None,
    )
    if cfg.instance_block_size > 1:
        return instance.sample_instance_bases_blocked(
            key, table, scene.pos, scene.normal, class_prob,
            scene.edge_prob, scene.pixel, scene.valid, scene.edge_free,
            block_size=cfg.instance_block_size, **kwargs,
        )
    return instance.sample_instance_bases_stepwise(
        key, table, scene.pos, scene.normal, class_prob,
        scene.edge_prob, scene.pixel, scene.valid, scene.edge_free,
        block=cfg.instance_scan_block, **kwargs,
    )


def _run_congruent(key, model: ModelPack, scene: ScenePack,
                   bases: sampling.SampledBases, cfg: MatchConfig,
                   d2_implied: bool):
    """Congruent extraction; `d2_implied` (congruent.d2_test_implied, read
    once per model and config) says whether cell equality implies the
    distance test."""
    return congruent.extract_congruent_sets(
        key, model.table, model.pos, scene.pos, scene.normal,
        bases.indices, bases.invariant1, bases.invariant2, bases.valid, cfg,
        pair_ep=model.pair_ep, d2_implied=d2_implied,
    )


def _pair_ep_of(model: ModelPack):
    """The model's endpoint-row table, built when the pack omitted it."""
    if model.pair_ep is not None:
        return model.pair_ep
    return build_pair_ep(model.pos, model.table.pairs)


def _ep_quad(pair_ep, flat_pairs):
    """[..., 2] winner pair rows -> [..., 4, 3] model quad positions (one
    endpoint-row read per pair)."""
    ep = pair_ep[flat_pairs.long()]                  # [..., 2, 6]
    return ep.reshape(ep.shape[:-2] + (4, 3))


def _phase_fit(scene_pos, pair_ep, scene_centroid, model_centroid,
               bases: sampling.SampledBases, sets: congruent.CongruentSets,
               compact_cap: int = 0):
    """Rigid transforms for every congruent slot. Returns (poses,
    n_slot_valid), the count of congruent-valid slots before fit validity.

    `compact_cap` > 0 with more slots than the cap: the valid slots are
    stably partitioned to the front and only the leading `compact_cap`
    are fitted (at the smallest bucket width covering them)."""
    b, k, _ = sets.pairs.shape
    h = b * k
    slot_valid = (sets.quad_valid & bases.valid[:, None]).reshape(h)
    n_slot_valid = slot_valid.sum(dtype=torch.int32)
    if compact_cap and h > compact_cap:
        cap = compact_cap
        sel = scoring._stable_partition_sel(slot_valid, cap)
        bi = sel // k
        flat_pairs = sets.pairs.reshape(h, 2)

        def fit_at(width):
            w_sel = sel[:width]
            out = fit_ops.fit_congruent_pairs(
                scene_pos[bases.indices[bi[:width]].long()],
                _ep_quad(pair_ep, flat_pairs[w_sel]),
                scene_centroid, model_centroid,
            )

            def padded(a):
                pad = cap - width
                if pad == 0:
                    return a
                return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])

            return PoseCandidates(
                transform=padded(out["transform"]),
                world_transform=padded(out["world_transform"]),
                lcp=torch.zeros(cap, dtype=torch.float32, device=scene_pos.device),
                base_index=bi.to(torch.int32),
                valid=padded(out["valid"] & slot_valid[w_sel]),
            )

        nvc = torch.clamp(n_slot_valid, max=cap)
        return scoring.run_bucketed(nvc, cap, fit_at), n_slot_valid
    scene_quad = scene_pos[bases.indices.long()]                # [B, 4, 3]
    scene_quad = scene_quad[:, None].expand(b, k, 4, 3)
    model_quad = _ep_quad(pair_ep, sets.pairs)                  # [B, K, 4, 3]
    out = fit_ops.fit_congruent_pairs(scene_quad, model_quad,
                                      scene_centroid, model_centroid)
    base_index = torch.arange(b, dtype=torch.int32, device=scene_pos.device)
    return PoseCandidates(
        transform=out["transform"].reshape(h, 4, 4),
        world_transform=out["world_transform"].reshape(h, 4, 4),
        lcp=torch.zeros(h, dtype=torch.float32, device=scene_pos.device),
        base_index=base_index[:, None].expand(b, k).reshape(h),
        valid=out["valid"].reshape(h) & slot_valid,
    ), n_slot_valid


def _phase_score(poses: PoseCandidates, model: ModelPack, scene: ScenePack,
                 class_prob, cfg: MatchConfig, coarse_to_fine: bool,
                 precompacted_count=None):
    mc = model.valid.to(torch.float32).sum()
    if coarse_to_fine:
        scores = scoring.score_hybrid(
            poses.transform, poses.valid, model.pos, model.normal, model.valid,
            scene.field, scene.grid, scene.pos, scene.normal, class_prob,
            cfg.distance_threshold, cfg.lcp_normal_angle_threshold,
            model_count=mc, compact_cap=cfg.score_compact_cap,
            mid_cap=cfg.score_mid_cap, precompacted_count=precompacted_count,
        )
    else:
        scores = scoring.score_transforms(
            poses.transform, poses.valid, model.pos, model.normal, model.valid,
            scene.grid, scene.pos, scene.normal, class_prob,
            cfg.distance_threshold, cfg.lcp_normal_angle_threshold,
            model_count=mc,
            chunk=scoring.exact_score_chunk(
                cfg.score_exact_chunk, model.pos.shape[0], scene.grid.cell_cap),
        )
    idx, best = scoring.best_pose(scores)
    return scores, idx, best


def _score_prob(scene: ScenePack, prior):
    """What scoring reads for `prior`: None (the weight baked into the
    field rows / payload) while it is the pristine vector the scene's
    structures were built with; the vector otherwise."""
    if (prior is scene.class_prob and scene.field.has_probs
            and scene.grid.has_probs):
        return None
    return prior


def _phases_234(k_cong, model: ModelPack, scene: ScenePack, prior, bases,
                cfg: MatchConfig, coarse_to_fine: bool, d2_implied: bool):
    """Congruent -> fit -> score for a set of sampled bases, with the
    fit-time compaction, scored under `prior` (_score_prob). Returns
    (scores [H], transforms [H, 4, 4], world_transforms [H, 4, 4], valid
    [H], n_slot_valid, pair_max, shortfall)."""
    sets = _run_congruent(k_cong, model, scene, bases, cfg, d2_implied)
    cap = cfg.score_compact_cap if coarse_to_fine else 0
    poses, n_slot_valid = _phase_fit(
        scene.pos, _pair_ep_of(model), scene.centroid, model.centroid, bases,
        sets, compact_cap=cap,
    )
    slots = bases.valid.shape[0] * cfg.maximum_congruent_sets
    pre_n = torch.clamp(n_slot_valid, max=cap) if (cap and slots > cap) else None
    scores, _i, _b = _phase_score(poses, model, scene, _score_prob(scene, prior),
                                  cfg, coarse_to_fine, precompacted_count=pre_n)
    return (scores, poses.transform, poses.world_transform, poses.valid,
            n_slot_valid, sets.pair_counts.max(),
            congruent.selection_shortfall(sets, cfg))


def _phase_refine(best_t, model: ModelPack, scene: ScenePack, class_prob,
                  cfg: MatchConfig):
    refined = icp.refine_pose(
        best_t, model.pos, model.valid, scene.icp_grid, scene.pos,
        scene.normal, max_corr_dist=cfg.icp_max_corr_dist,
        iterations=cfg.icp_iterations,
    )
    one = torch.ones(1, dtype=torch.bool, device=best_t.device)
    new_lcp = scoring.score_transforms(
        refined[None], one, model.pos, model.normal, model.valid,
        scene.grid, scene.pos, scene.normal, class_prob,
        cfg.distance_threshold, cfg.lcp_normal_angle_threshold,
        model_count=model.valid.to(torch.float32).sum(),
    )[0]
    return refined, new_lcp


_FIELD_SCORE_CHUNK = 8192   # hypotheses per dense-field pass over a pool


def _phase_field_scores(poses: PoseCandidates, model: ModelPack,
                        scene: ScenePack, class_prob, cfg: MatchConfig):
    """Full-model dense-field LCP for every hypothesis (the ladder's
    mid-stage scorer over the whole pool), used to backfill non-leader
    scores for clustering. Hypotheses are independent, so the pool goes
    through in chunks that bound the [chunk, M, 8] row reads."""
    mc = model.valid.to(torch.float32).sum()
    h = poses.transform.shape[0]
    return torch.cat([
        scoring.score_transforms_field(
            poses.transform[i:i + _FIELD_SCORE_CHUNK],
            poses.valid[i:i + _FIELD_SCORE_CHUNK],
            model.pos, model.normal, model.valid, scene.field, class_prob,
            cfg.distance_threshold, cfg.lcp_normal_angle_threshold,
            model_count=mc,
        ) for i in range(0, h, _FIELD_SCORE_CHUNK)
    ])


_SWEEP_CKPT_VERSION = 3  # v2: + chunk_slot_valid (fit-time compaction)
#                          v3: + devices (0 = the one-device layout)


def _sweep_cfg_fingerprint(cfg: MatchConfig) -> str:
    """Stable fingerprint of the config: a resumed sweep must run under the
    configuration that produced the checkpoint. The same string as the JAX
    package computes for the same config (config.py is a field-for-field
    copy)."""
    d = dataclasses.asdict(cfg)
    return hashlib.sha1(
        json.dumps(d, sort_keys=True, default=repr).encode()
    ).hexdigest()


def _save_sweep_checkpoint(path, *, next_chunk, chunk, seed, kp, cfg_fp,
                           use_instance, pool_s, pool_t, pool_w,
                           chunk_valid, chunk_slot_valid, unconverged,
                           elapsed, prob_decayed, class_prob, devices=0,
                           pair_max=0):
    """Atomic npz checkpoint of a sweep in progress, in the JAX package's
    format (same keys, version 3). Chunk keys are fold_in(key0, ci),
    stateless in the loop, so the only cross-chunk state is the pooled
    winners and (instance mode) the decayed prior: resuming reproduces the
    uninterrupted sweep bit for bit. `unconverged` and `pair_max` arrive as
    0-dim tensors and ride the one transfer."""
    host = _to_host(pool_s, pool_t, pool_w, chunk_valid, chunk_slot_valid,
                    unconverged, pair_max,
                    *([class_prob] if prob_decayed else []))
    arrays = dict(
        version=np.int64(_SWEEP_CKPT_VERSION),
        next_chunk=np.int64(next_chunk),
        chunk=np.int64(chunk),
        seed=np.int64(seed),
        kp=np.int64(kp),
        cfg_fp=np.frombuffer(cfg_fp.encode(), dtype=np.uint8),
        use_instance=np.bool_(use_instance),
        pool_s=host[0].astype(np.float32),
        pool_t=host[1].astype(np.float32),
        pool_w=host[2].astype(np.float32),
        chunk_valid=host[3].astype(np.int32),
        chunk_slot_valid=host[4].astype(np.int32),
        unconverged=np.int64(host[5]),
        elapsed=np.float64(elapsed),
        prob_decayed=np.bool_(prob_decayed),
        devices=np.int64(devices),
        # the running PPF pair maximum: without it a truncated bin of a
        # chunk before the checkpoint would be forgotten on resume
        pair_max=np.int64(host[6]),
    )
    if prob_decayed:
        arrays["class_prob"] = host[7].astype(np.float32)
    # a file of its own for each process: the processes of a sharded sweep
    # write the same checkpoint
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _load_sweep_checkpoint(path, *, chunk, seed, kp, cfg_fp, use_instance,
                           device, devices=0):
    """Load a sweep checkpoint (versions 1-3) onto `device` and validate it
    against this call's parameters. Raises ValueError on any mismatch: a
    checkpoint never resumes under different semantics."""
    with np.load(path) as z:
        ver = int(z["version"])
        if ver not in (1, 2, _SWEEP_CKPT_VERSION):
            raise ValueError(
                f"sweep checkpoint {path}: unsupported version {ver}"
            )
        saved_fp = bytes(z["cfg_fp"]).decode()
        mism = []
        if int(z["chunk"]) != chunk:
            mism.append(f"chunk {int(z['chunk'])} != {chunk}")
        if int(z["seed"]) != seed:
            mism.append(f"seed {int(z['seed'])} != {seed}")
        if int(z["kp"]) != kp:
            mism.append(f"keep_per_chunk {int(z['kp'])} != {kp}")
        if saved_fp != cfg_fp:
            mism.append("config fingerprint differs")
        if bool(z["use_instance"]) != use_instance:
            mism.append("sampling path (instance/class) differs")
        saved_dev = int(z["devices"]) if ver >= 3 else 0
        if saved_dev != devices:
            mism.append(
                f"device layout {saved_dev or 'single-chip'} != "
                f"{devices or 'single-chip'}"
            )
        if mism:
            raise ValueError(
                f"sweep checkpoint {path} does not match this sweep: "
                + "; ".join(mism)
            )

        def dev(name):
            return torch.from_numpy(np.array(z[name])).to(device)

        prob_decayed = bool(z["prob_decayed"])
        return dict(
            next_chunk=int(z["next_chunk"]),
            pool_s=dev("pool_s"), pool_t=dev("pool_t"), pool_w=dev("pool_w"),
            chunk_valid=dev("chunk_valid"),
            # version 1 lacks the per-chunk congruent-valid counts: fall
            # back to the fit-valid counts (a lower bound; the overflow
            # warning may under-fire for the resumed chunks)
            chunk_slot_valid=dev("chunk_slot_valid" if ver >= 2 else "chunk_valid"),
            unconverged=int(z["unconverged"]),
            pair_max=(int(z["pair_max"]) if "pair_max" in z.files else 0),
            elapsed=float(z["elapsed"]),
            prob_decayed=prob_decayed,
            class_prob=dev("class_prob") if prob_decayed else None,
        )


def _cluster_pool(world, lcp, valid, best_score, cfg: MatchConfig):
    """Greedy clustering of a scored pool under the config's thresholds;
    returns (world transforms [K, 4, 4], lcp [K]) of the representatives as
    float32 numpy arrays (one transfer)."""
    idx, mask = clustering.greedy_clustering(
        world, lcp, valid, cfg.cluster_acceptable_fraction, best_score,
        cfg.cluster_max_pose_count, cfg.cluster_min_distance,
        cfg.cluster_min_angle,
        torch.tensor(cfg.cluster_symmetry, dtype=torch.float32,
                     device=world.device),
    )
    safe = torch.clamp(idx, min=0).long()
    h_mask, h_w, h_s = _to_host(mask, world[safe], lcp[safe])
    keep = h_mask.astype(bool)
    return h_w[keep].astype(np.float32), h_s[keep].astype(np.float32)


def _world_of(centered, scene_centroid, model_centroid):
    """world = T(+scene_centroid) centered T(-model_centroid), float32 on
    the host."""
    a = np.eye(4, dtype=np.float32)
    a[:3, 3] = scene_centroid
    b = np.eye(4, dtype=np.float32)
    b[:3, 3] = -model_centroid
    return a @ centered @ b


def finish_sweep_pool(pool_s, pool_t, pool_w, model: ModelPack,
                      scene: ScenePack, class_prob, cfg: MatchConfig,
                      total_bases: int, n_hyp_total: int, t_start: float,
                      chunks: int, verbose: bool = True, event: str = "stocs_sweep",
                      extra_stats: Optional[dict] = None):
    """Tail of a sweep: pool argmax, ICP polish of the winner, greedy
    clustering of the pooled hypotheses (pruned against the raw pool best:
    an ICP-refined best is no member of the pool and would over-prune),
    stats and logging, in the span `sweep.finish`. Three transfers: argmax
    group, refine group, cluster group.

    The pool holds `chunks` chunks of equal length in chunk order; stats
    name the chunk of the pool's argmax (`best_chunk`) and whether the ICP
    polish replaced its entry (`best_refined`).

    Returns (best_lcp, best_world_transform, clustered_transforms,
    clustered_lcp, stats)."""
    with trace.span("sweep.finish"):
        bi = torch.argmax(pool_s)
        h_bi, h_best, h_w, h_sc, h_mc = _to_host(bi, pool_s[bi], pool_w[bi],
                                                 scene.centroid, model.centroid)
        best_lcp = float(h_best)
        best_w = h_w.astype(np.float32)
        raw_best = best_lcp
        refined_won = False

        if cfg.refine_best_pose and best_lcp > 0:
            refined, new_lcp = _phase_refine(pool_t[bi], model, scene, class_prob, cfg)
            r_refined, r_lcp = _to_host(refined, new_lcp)
            if float(r_lcp) >= best_lcp:
                best_w = _world_of(r_refined.astype(np.float32), h_sc, h_mc)
                best_lcp = float(r_lcp)
                refined_won = True
        elapsed = time.perf_counter() - t_start

        cl_w, cl_s = _cluster_pool(pool_w, pool_s, pool_s > 0, raw_best, cfg)
        stats = {
            "total_bases": total_bases,
            "hypotheses": n_hyp_total,
            "seconds": elapsed,
            "bases_per_sec": total_bases / elapsed,
            "hypotheses_per_sec": n_hyp_total / elapsed if elapsed else 0.0,
            # the pool's own best, before the ICP polish: the first cluster
            "pool_best_lcp": raw_best,
            "best_chunk": int(h_bi) // (pool_s.shape[0] // chunks),
            "best_refined": refined_won,
            **(extra_stats or {}),
        }
        log_event(event, best_lcp=best_lcp, clusters=len(cl_s), **stats)
        if verbose:
            print(
                f"sweep: {total_bases} bases -> {n_hyp_total} hypotheses in "
                f"{elapsed:.1f}s ({stats['bases_per_sec']:.0f} bases/s), "
                f"best lcp {best_lcp:.3f}, {len(cl_s)} clusters"
            )
        return best_lcp, best_w, cl_w, cl_s, stats


@dataclasses.dataclass
class _SweepChunk:
    """One chunk of a sweep as its step hands it to _sweep_chunks: the
    pooled winners, the device counters (0-dim int32) and the prior the
    next chunk samples under."""
    pool_s: torch.Tensor        # [k] scores
    pool_t: torch.Tensor        # [k, 4, 4] transforms
    pool_w: torch.Tensor        # [k, 4, 4] world transforms
    n_valid: torch.Tensor       # fit-valid hypotheses (the hypotheses stat)
    n_slot_valid: torch.Tensor  # congruent-valid slots before the fit-time
    #                             compaction (the overflow warning)
    pair_max: torch.Tensor
    shortfall: torch.Tensor
    prior: torch.Tensor
    unconverged: Optional[torch.Tensor] = None   # instance path
    counts: dict = dataclasses.field(default_factory=dict)  # the caller's own


def _sweep_chunks(step, model: ModelPack, scene: ScenePack, cfg: MatchConfig,
                  prior, *, total_bases: int, chunk: int, seed: int, kp: int,
                  t_start: float, verbose: bool, checkpoint_path,
                  checkpoint_every: int, stop_after_chunks,
                  coarse_to_fine: bool = True, devices: int = 0,
                  counts: Optional[dict] = None, baked_finish: bool = True):
    """The chunk loop of a sweep, one-device (`devices` 0) or over a mesh
    of `devices` ranks, around the caller's per-chunk work:
    `step(key, prior)` runs chunk ci under key fold_in(PRNGKey(seed), ci)
    and the prior the chunks before it left, and returns a _SweepChunk.

    The loop resumes from `checkpoint_path` (`kp` and `devices` are
    recorded there) and checkpoints on its cadence, keeps the pools and
    the counters on the device and reads them once after the loop (and
    once per checkpoint), warns of what cost recall, removes a finished
    sweep's checkpoint and hands the pool to finish_sweep_pool, scored
    under `prior` (through _score_prob when `baked_finish`). `counts` maps
    each name of a _SweepChunk's own counters to its value over no chunk;
    their sums over the chunks of this call go into the stats. `cfg` is
    the chunk's config (number_of_bases = chunk). Spans: `sweep.chunk`
    around each chunk; the caller's `sweep.run` around the call.

    On the instance path a running `torch.where` on each chunk's pool
    maximum keeps, on the device, the prior of the chunk that holds the
    pool's best entry so far (strictly greater replaces it, as the pool's
    argmax keeps the first of equal entries); the class path's prior is
    the one it was given.

    Returns (finish_sweep_pool's tuple, the prior the last chunk left, the
    prior that scored the returned best LCP: the last chunk's where the
    ICP polish replaced the pool's best, else the best entry's chunk's,
    None where that chunk ran before a resume)."""
    dev = scene.pos.device
    use_instance = scene.has_edge
    name = "sharded sweep" if devices else "sweep"
    event = "stocs_sweep_sharded" if devices else "stocs_sweep"
    n_chunks = -(-total_bases // chunk)
    key0 = rng.PRNGKey(seed)
    counts = counts or {}

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    pool_s, pool_t, pool_w = [], [], []
    chunk_valid, chunk_slot_valid = [], []
    pair_maxes, shortfalls, unconverged = [], [], []
    chunk_counts = {k: [] for k in counts}
    win_s = win_prior = None   # the best pool entry so far, its chunk's prior
    start_chunk = 0
    resumed_unconverged = 0
    resumed_pair_max = 0
    t_prev = 0.0
    cfg_fp = _sweep_cfg_fingerprint(cfg) if checkpoint_path else ""
    if checkpoint_path and os.path.exists(checkpoint_path):
        state = _load_sweep_checkpoint(
            checkpoint_path, chunk=chunk, seed=seed, kp=kp, cfg_fp=cfg_fp,
            use_instance=use_instance, device=dev, devices=devices,
        )
        start_chunk = state["next_chunk"]
        if start_chunk > n_chunks:
            raise ValueError(
                f"sweep checkpoint {checkpoint_path} has already "
                f"processed {start_chunk} chunks; this call asks for "
                f"only {n_chunks} — raise total_bases (resuming with a "
                f"larger budget extends the sweep)"
            )
        if start_chunk:
            pool_s.append(state["pool_s"].reshape(-1))
            if use_instance:
                win_s, win_prior = pool_s[0].max(), prior
            pool_t.append(state["pool_t"].reshape(-1, 4, 4))
            pool_w.append(state["pool_w"].reshape(-1, 4, 4))
            # the per-chunk counts survive the round trip so that the
            # overflow warning keeps its per-chunk maximum
            chunk_valid.extend(state["chunk_valid"].reshape(-1))
            chunk_slot_valid.extend(state["chunk_slot_valid"].reshape(-1))
        resumed_unconverged = state["unconverged"]
        resumed_pair_max = state["pair_max"]
        t_prev = state["elapsed"]
        if state["prob_decayed"]:
            prior = state["class_prob"]
        log_event(f"{event}_resume", path=checkpoint_path,
                  next_chunk=start_chunk, n_chunks=n_chunks,
                  **({"devices": devices} if devices else {}))
        if verbose:
            print(f"{name}: resumed from {checkpoint_path} at chunk "
                  f"{start_chunk}/{n_chunks}")

    def total(parts, base=0):
        """0-dim int32: `base` plus the sum of the device counters."""
        return torch.stack(parts).sum(dtype=torch.int32) + base if parts else i32(base)

    def running_pair_max():
        if not pair_maxes:
            return i32(resumed_pair_max)
        return torch.clamp(torch.stack(pair_maxes).max(), min=resumed_pair_max)

    def save_ckpt(next_chunk):
        _save_sweep_checkpoint(
            checkpoint_path, next_chunk=next_chunk, chunk=chunk, seed=seed,
            kp=kp, cfg_fp=cfg_fp, use_instance=use_instance, devices=devices,
            # a resumed pool's first entry is flat [start * kp]; one
            # concatenation and reshape restore the per-chunk layout
            pool_s=torch.cat(pool_s).reshape(next_chunk, -1),
            pool_t=torch.cat(pool_t).reshape(next_chunk, -1, 4, 4),
            pool_w=torch.cat(pool_w).reshape(next_chunk, -1, 4, 4),
            chunk_valid=torch.stack(chunk_valid),
            chunk_slot_valid=torch.stack(chunk_slot_valid),
            unconverged=total(unconverged, resumed_unconverged),
            elapsed=t_prev + (time.perf_counter() - t_start),
            prob_decayed=prior is not scene.class_prob,
            class_prob=prior,
            pair_max=running_pair_max(),
        )

    stopped_at = None
    for ci in range(start_chunk, n_chunks):
        with trace.span("sweep.chunk"):
            c = step(rng.fold_in(key0, ci), prior)
            prior = c.prior
            if use_instance:
                top = c.pool_s.max()
                if win_s is None:
                    win_s, win_prior = top, prior
                else:
                    better = top > win_s
                    win_s = torch.where(better, top, win_s)
                    win_prior = torch.where(better, prior, win_prior)
            pool_s.append(c.pool_s)
            pool_t.append(c.pool_t)
            pool_w.append(c.pool_w)
            chunk_valid.append(c.n_valid)
            chunk_slot_valid.append(c.n_slot_valid)
            pair_maxes.append(c.pair_max)
            shortfalls.append(c.shortfall)
            if c.unconverged is not None:
                unconverged.append(c.unconverged)
            for k, v in c.counts.items():
                chunk_counts[k].append(v)
            done_this_call = ci + 1 - start_chunk
            if (stop_after_chunks is not None
                    and done_this_call >= stop_after_chunks
                    and ci + 1 < n_chunks):
                stopped_at = ci + 1
                if checkpoint_path:
                    save_ckpt(ci + 1)
                break
            if (checkpoint_path and ci + 1 < n_chunks
                    and done_this_call % max(1, checkpoint_every) == 0):
                save_ckpt(ci + 1)
    completed = stopped_at is None
    # one transfer for the loop's deferred device-side counters
    h_unconv, h_nvs, h_slvs, h_pmx, h_short, *h_counts = _to_host(
        total(unconverged, resumed_unconverged),
        torch.stack(chunk_valid) if chunk_valid else i32([0]),
        torch.stack(chunk_slot_valid) if chunk_slot_valid else i32([0]),
        running_pair_max(), total(shortfalls),
        *(torch.stack(v).sum(0) if v else counts[k]
          for k, v in chunk_counts.items()),
    )
    n_unconverged = int(h_unconv)
    if n_unconverged:
        warn(
            f"{n_unconverged} flood fills across the {name} did not "
            f"reach their BFS fixpoint in flood_fill_sweeps="
            f"{cfg.flood_fill_sweeps} sweeps — segments under-fill",
            n_unconverged=n_unconverged, sweeps=cfg.flood_fill_sweeps,
        )
    n_hyp_total = int(h_nvs.sum())
    # the overflow check uses the congruent-valid counts from before the
    # compaction (fit compacts to the cap, so fit-valid counts never
    # exceed it); a rank fits its share of the chunk
    cap = cfg.score_compact_cap
    slots = chunk // max(1, devices) * cfg.maximum_congruent_sets
    slot_max = int(h_slvs.max())
    if coarse_to_fine and cap and slots > cap and slot_max > cap:
        fitted = "a device's chunk shard" if devices else "a chunk"
        warn(
            f"{fitted} produced {slot_max} congruent-valid hypothesis slots, over "
            f"score_compact_cap={cap}; overflow was not fitted or scored "
            f"— raise the cap for full recall",
            n_valid=slot_max, cap=cap,
        )
    has_pair_max = bool(pair_maxes) or bool(resumed_pair_max)
    pair_max = int(h_pmx)
    if has_pair_max and pair_max > cfg.max_pairs_per_bin:
        warn(
            f"a PPF bin held {pair_max} pairs; only "
            f"max_pairs_per_bin={cfg.max_pairs_per_bin} were matched — "
            f"raise the cap for full recall",
            pair_max=pair_max, cap=cfg.max_pairs_per_bin,
        )
    if int(h_short):
        warn(
            f"{int(h_short)} saturated bases kept fewer than "
            f"maximum_congruent_sets={cfg.maximum_congruent_sets} sets "
            f"after the exact-cone re-check — raise "
            f"congruent_cone_oversample for full selection",
            n_short=int(h_short),
            oversample=cfg.congruent_cone_oversample,
        )
    if completed and checkpoint_path:
        # the processes of a group may share the file
        with contextlib.suppress(FileNotFoundError):
            os.remove(checkpoint_path)
    processed = (stopped_at if stopped_at is not None else n_chunks) * chunk
    extra = {"devices": devices} if devices else {}
    extra["completed"] = completed
    extra.update((k, [int(v) for v in h]) for k, h in zip(chunk_counts, h_counts))
    if has_pair_max:
        # exposed so that callers can fail on a truncation that costs
        # recall instead of relying on the warning text
        extra["pair_count_max"] = pair_max
    if not completed:
        extra["next_chunk"] = stopped_at
    out = finish_sweep_pool(
        torch.cat(pool_s), torch.cat(pool_t), torch.cat(pool_w), model, scene,
        _score_prob(scene, prior) if baked_finish else prior, cfg,
        total_bases=processed, n_hyp_total=n_hyp_total,
        # resumed time counts: finish measures now - t_start
        t_start=t_start - t_prev, chunks=processed // chunk, verbose=verbose,
        event=event, extra_stats=extra,
    )
    stats = out[4]
    if stats["best_refined"] or not use_instance:
        scored = prior
    elif stats["best_chunk"] < start_chunk:
        scored = None
    else:
        scored = win_prior
    return out, prior, scored


class StocsEstimator:
    """Matches one model against one scene, on the device of the packs. The
    class path (no edge map) is fully batched; the instance path threads
    flood-fill segments through a sequential loop (instance.py)."""

    def __init__(self, model: ModelPack, scene: ScenePack, cfg: MatchConfig):
        with trace.span("estimate.setup"):
            # STOCS learns nothing and its float work is small, so exactness
            # wins: matrix products and score sums must run in true fp32,
            # not TF32 (which keeps ~3 decimal digits and would move
            # distance, normal and cone gate decisions).
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            self.model = model
            self.scene = scene
            self.cfg = cfg
            # mutable class-probability state: the instance path decays
            # it, and scoring reads the decayed values
            self.class_prob = scene.class_prob
            # the prior that scored the last sweep's best LCP (run_sweep)
            self.best_prior = None
            self.seg_masks = None
            self.last_poses = None
            self._exists_bits = None
            # fixed per model and config: one host read here, none per run
            self._d2_implied = congruent.d2_test_implied(model.pos, cfg)

    def _score_prob(self):
        """What scoring reads for the estimator's prior (_score_prob)."""
        return _score_prob(self.scene, self.class_prob)

    def exists_bits(self):
        """The bit-packed pair-existence matrix, built at first use: one
        O(N^2) pass, after which every sampling round's PPF mask is a row
        read. Used by `run` from 512 bases up and by every class-path
        sweep; never by the instance path, whose rounds mask one base at a
        time."""
        if self._exists_bits is None:
            self._exists_bits = sampling.build_exists_bits(
                self.model.table, self.scene.pos, self.scene.normal,
                self.cfg.ppf_tr_discretization,
                self.cfg.ppf_rot_discretization,
            )
        return self._exists_bits

    def run(self, seed: Optional[int] = None, coarse_to_fine: bool = True,
            verbose: bool = True) -> StocsResult:
        """One match: the four phases, the host read of their outcome and
        the ICP polish, in the span `estimate.run`; `timings` holds the
        seconds of its children `estimate.sample` (sample_bases),
        `estimate.congruent` (congruent_sets), `estimate.fit` (rigid_fit),
        `estimate.score` (scoring) and `estimate.icp` (icp_refine)."""
        with trace.span("estimate.run"):
            return self._run(seed, coarse_to_fine, verbose)

    def _run(self, seed, coarse_to_fine, verbose) -> StocsResult:
        cfg = self.cfg
        dev = self.scene.pos.device
        key = rng.PRNGKey(cfg.seed if seed is None else seed)
        k_sample, k_cong = rng.split(key)
        timings = {}

        with trace.span("estimate.sample", sync=dev) as sp:
            self.seg_masks = None
            unconv = torch.zeros((), dtype=torch.int32, device=dev)
            if self.scene.has_edge:
                inst = _phase_sample_instance(
                    k_sample, self.model.table, self.scene, self.class_prob,
                    cfg, cfg.number_of_bases,
                )
                # joins the one transfer below
                unconv = (~inst.fill_converged).sum(dtype=torch.int32)
                bases = sampling.SampledBases(
                    inst.indices, inst.invariant1, inst.invariant2, inst.valid
                )
                # the dispersion decay persists into scoring
                self.class_prob = inst.class_prob
                self.seg_masks = inst.seg_masks
            else:
                bits = self.exists_bits() if cfg.number_of_bases >= 512 else None
                bases = _phase_sample(
                    k_sample, self.model.table, self.scene.pos, self.scene.normal,
                    self.class_prob, self.scene.valid, cfg, cfg.number_of_bases,
                    bits,
                )
        timings["sample_bases"] = sp.seconds

        with trace.span("estimate.congruent", sync=dev) as sp:
            sets = _run_congruent(k_cong, self.model, self.scene, bases, cfg,
                                  self._d2_implied)
        timings["congruent_sets"] = sp.seconds

        with trace.span("estimate.fit", sync=dev) as sp:
            cap = cfg.score_compact_cap
            fit_cap = cap if coarse_to_fine else 0
            poses, n_slot_valid = _phase_fit(
                self.scene.pos, _pair_ep_of(self.model), self.scene.centroid,
                self.model.centroid, bases, sets, compact_cap=fit_cap,
            )
        timings["rigid_fit"] = sp.seconds
        slots = bases.valid.shape[0] * cfg.maximum_congruent_sets

        with trace.span("estimate.score", sync=dev) as sp:
            pre_n = (torch.clamp(n_slot_valid, max=cap)
                     if (fit_cap and slots > cap) else None)
            scores, idx, best = _phase_score(
                poses, self.model, self.scene, self._score_prob(), cfg,
                coarse_to_fine, precompacted_count=pre_n,
            )
        timings["scoring"] = sp.seconds

        with trace.span("estimate.read"):
            poses = dataclasses.replace(poses, lcp=scores)
            # one transfer for every host-side scalar and the winner rows
            safe_i = torch.clamp(idx, min=0).long()
            (h_idx, h_best, h_nb, h_nh, h_nsv, h_pmax, h_short, h_tot, best_t,
             best_w, h_unconv) = _to_host(
                idx, best, bases.valid.sum(dtype=torch.int32),
                poses.valid.sum(dtype=torch.int32), n_slot_valid,
                sets.pair_counts.max(), congruent.selection_shortfall(sets, cfg),
                sets.total_found.sum(), poses.transform[safe_i],
                poses.world_transform[safe_i], unconv,
            )
        n_bases, n_hyp, n_slot_valid = int(h_nb), int(h_nh), int(h_nsv)
        pair_max, shortfall, total_sets = int(h_pmax), int(h_short), int(h_tot)
        n_unconv = int(h_unconv)
        if n_unconv:
            warn(
                f"{n_unconv} flood fills did not reach their BFS fixpoint in "
                f"flood_fill_sweeps={cfg.flood_fill_sweeps} sweeps — "
                f"segments under-fill; raise the sweep count for scenes "
                f"with winding free-space regions",
                n_unconverged=n_unconv, sweeps=cfg.flood_fill_sweeps,
            )
        if verbose:
            print(f"Sampled {n_bases} bases in "
                  f"{timings['sample_bases']*1e6:.0f} us")
            print(f"found {total_sets} congruent sets ({n_hyp} hypotheses) in "
                  f"{(timings['congruent_sets']+timings['rigid_fit'])*1e6:.0f} us")
        if pair_max > cfg.max_pairs_per_bin:
            warn(
                f"a PPF bin held {pair_max} pairs; only "
                f"max_pairs_per_bin={cfg.max_pairs_per_bin} were matched — "
                f"raise the cap for full recall",
                pair_max=pair_max, cap=cfg.max_pairs_per_bin,
            )
        if shortfall:
            warn(
                f"{shortfall} saturated bases kept fewer than "
                f"maximum_congruent_sets={cfg.maximum_congruent_sets} sets "
                f"after the exact-cone re-check — the kept pool may be "
                f"thinner than the reference's cap; raise "
                f"congruent_cone_oversample for full selection",
                n_short=shortfall, oversample=cfg.congruent_cone_oversample,
            )
        if coarse_to_fine and cap and slots > cap and n_slot_valid > cap:
            warn(
                f"{n_slot_valid} congruent-valid hypothesis slots exceed "
                f"score_compact_cap={cap}; overflow was not fitted or "
                f"scored — raise the cap for full recall",
                n_valid=n_slot_valid, cap=cap,
            )
        if verbose:
            print(f"evaluated transforms in {timings['scoring']*1e6:.0f} us")

        best_index = int(h_idx)
        best_lcp = float(h_best)
        if verbose:
            print(f"best index: {best_index}, maximum score: {best_lcp}")
        best_t = best_t.astype(np.float32) if best_index >= 0 else None
        best_w = best_w.astype(np.float32) if best_index >= 0 else None

        # point-to-plane ICP polish of the winner, kept when it scores >= raw
        if best_index >= 0 and cfg.refine_best_pose:
            with trace.span("estimate.icp", timed=True) as sp:
                refined, new_lcp = _phase_refine(
                    torch.from_numpy(best_t).to(dev), self.model, self.scene,
                    self._score_prob(), cfg,
                )
                r_refined, r_lcp, r_sc, r_mc = _to_host(
                    refined, new_lcp, self.scene.centroid, self.model.centroid)
            new_lcp = float(r_lcp)
            timings["icp_refine"] = sp.seconds
            if new_lcp >= best_lcp:
                best_t = r_refined.astype(np.float32)
                best_w = _world_of(best_t, r_sc, r_mc)
                best_lcp = new_lcp
                if verbose:
                    print(f"icp refined score: {best_lcp}")

        self.last_poses = poses
        hyps_per_sec = n_hyp / timings["scoring"] if timings["scoring"] > 0 else 0.0
        log_event(
            "stocs_run", best_lcp=best_lcp, best_index=best_index,
            bases=n_bases, hypotheses=n_hyp, device=str(dev),
            unconverged_fills=n_unconv,
            timings_ms={k: round(v * 1e3, 3) for k, v in timings.items()},
        )
        return StocsResult(
            poses=poses,
            best_index=best_index,
            best_lcp=best_lcp,
            best_transform=best_t,
            best_world_transform=best_w,
            num_bases=n_bases,
            num_hypotheses=n_hyp,
            timings=timings,
            stats={
                "hypotheses_per_sec": hyps_per_sec,
                "congruent_total": total_sets,
                "pair_count_max": pair_max,
                "selection_shortfall": shortfall,
                # only the coarse-to-fine ladder leaves -1 (unscored)
                # entries, which cluster_poses backfills
                "coarse_to_fine": coarse_to_fine,
                "unconverged_fills": n_unconv,
            },
        )

    def run_sweep(self, total_bases: int, chunk: int = 2048,
                  keep_per_chunk: Optional[int] = None,
                  seed: Optional[int] = None,
                  verbose: bool = True,
                  checkpoint_path: Optional[str] = None,
                  checkpoint_every: int = 8,
                  stop_after_chunks: Optional[int] = None):
        """Large hypothesis sweep: process `total_bases` bases in chunks of
        `chunk` through the same phases, keep the top `keep_per_chunk`
        scored poses of each chunk, and greedily cluster the pool at the
        end.

        Edge-mapped scenes run the instance path per chunk, with the
        dispersion decay threaded across chunks (chunk ci+1's prior
        reflects every base of chunks 0..ci), and each chunk is scored with
        its sampling-time prior. The decayed prior stays on the estimator
        afterwards, as after run(). Each chunk's segment masks are dropped.
        The decay makes each chunk's scores smaller than the chunk's before
        it (every segment's weight falls by `sample_dispersion` each time a
        base lands in it), so on a bin of like boxes the first chunk holds
        the pool's best entry, and later chunks only add to the clusters.

        Returns (best_lcp, best_world_transform, clustered_transforms,
        clustered_lcp, stats). A `total_bases` that is not a multiple of
        `chunk` is rounded up; stats report the bases processed, the chunk
        whose pool entry is the pool's best (`best_chunk`) and whether the
        ICP polish replaced it (`best_refined`). `best_prior` on the
        estimator is then the prior that scored `best_lcp`, on the device:
        the polish's (the last chunk's) where it replaced the pool's best,
        else the best chunk's; the scene's on the class path; None where
        the best chunk ran before a resume from a checkpoint, which records
        only the last prior.

        keep_per_chunk None -> cfg.sweep_keep_per_chunk; 0 -> pool every
        scored hypothesis slot.

        `checkpoint_path`: persist the sweep state (pooled winners, chunk
        cursor, decayed prior) every `checkpoint_every` chunks; a later
        call with the same arguments resumes from the cursor and, because
        chunk keys are fold_in(key0, ci), reproduces the uninterrupted
        sweep bit for bit. The file is removed on completion. A mismatched
        chunk, seed, keep or config raises. `stop_after_chunks` bounds how
        many chunks this call processes: the call checkpoints, returns the
        result of the pool so far, and sets stats["completed"] = False and
        stats["next_chunk"].

        The per-chunk counters stay on the device; the host reads them
        once after the loop, and once per checkpoint.

        Spans: `sweep.run` around the call, `sweep.chunk` around each
        chunk, and inside it on the instance path `sweep.sample` around the
        sampler (it ends on a synchronize), `sweep.finish` around the tail
        (finish_sweep_pool)."""
        cfg = dataclasses.replace(self.cfg, number_of_bases=chunk)
        if keep_per_chunk is None:
            keep_per_chunk = cfg.sweep_keep_per_chunk
        use_instance = self.scene.has_edge

        def step(key, prior):
            k_sample, k_cong = rng.split(key)
            unconverged = None
            if use_instance:
                with trace.span("sweep.sample", sync=self.scene.pos.device):
                    inst = _phase_sample_instance(
                        k_sample, self.model.table, self.scene, prior, cfg, chunk,
                    )
                bases = sampling.SampledBases(
                    inst.indices, inst.invariant1, inst.invariant2, inst.valid
                )
                # thread the decay: the next chunk samples (and this chunk
                # scores) under the prior every previous base has decayed
                prior = inst.class_prob
                unconverged = (~inst.fill_converged).sum(dtype=torch.int32)
                del inst
            else:
                bases = _phase_sample(
                    k_sample, self.model.table, self.scene.pos,
                    self.scene.normal, prior, self.scene.valid, cfg, chunk, bits,
                )
            scores, trans, world, valid, n_slot_valid, pair_max, short = _phases_234(
                k_cong, self.model, self.scene, prior, bases, cfg, True,
                self._d2_implied,
            )
            kp = keep_per_chunk or scores.shape[0]
            # values descending, ties by ascending index, on every device
            top, idx = scoring._top_k(scores, min(kp, scores.shape[0]))
            return _SweepChunk(top, trans[idx], world[idx],
                               valid.sum(dtype=torch.int32), n_slot_valid,
                               pair_max, short, prior, unconverged)

        with trace.span("sweep.run"):
            t_start = time.perf_counter()
            bits = None if use_instance else self.exists_bits()
            out, self.class_prob, self.best_prior = _sweep_chunks(
                step, self.model, self.scene, cfg, self.class_prob,
                total_bases=total_bases, chunk=chunk,
                seed=cfg.seed if seed is None else seed, kp=keep_per_chunk,
                t_start=t_start, verbose=verbose, checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every,
                stop_after_chunks=stop_after_chunks,
            )
        return out

    def cluster_poses(self, result: StocsResult):
        """Symmetry-aware greedy clustering of the scored hypothesis set.
        Returns (world_transforms [K, 4, 4], lcp [K]) of the cluster
        representatives.

        A coarse-to-fine run stores an exact LCP only for the ladder's
        leaders (-1 elsewhere). To keep the whole pool clusterable, the
        other entries are filled with their dense-field LCP estimate (the
        ladder's own mid-stage scorer); leaders keep their exact scores.
        Whether to fill is read from the result's stats, not from the
        device."""
        poses = result.poses
        lcp = poses.lcp
        if result.stats.get("coarse_to_fine", True):
            field_scores = _phase_field_scores(
                poses, self.model, self.scene, self._score_prob(), self.cfg
            )
            lcp = torch.where(lcp >= 0, lcp, field_scores)
        # prune against the raw pool best: result.best_lcp may be the
        # ICP-refined winner, which is no member of the pool
        raw_best = torch.where(poses.valid, lcp, -torch.inf).max()
        return _cluster_pool(poses.world_transform, lcp, poses.valid,
                             raw_best, self.cfg)
