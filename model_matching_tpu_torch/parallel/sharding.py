"""Sharded matching over a 1-D mesh of ranks.

Counterpart of ``model_matching_tpu/parallel/sharding.py``. The full online
step (sample -> congruent -> fit -> score) runs on every rank for its share
of the bases, end to end: the model, scene and PPF table are replicated
(they are small; the hypothesis work is the load), and the only
communication is the final weighted-LCP argmax of a step, or a sweep
chunk's pooled top-k and its counters.

A rank is a device of one process. Ranks may share a device:
``make_mesh(["cpu"] * 8)`` is eight ranks on the CPU and ``make_mesh(
[torch.device("cuda", 0)] * 8)`` eight on one card; a process runs its
ranks' shares one after another, in rank order. Under torch.distributed
the mesh is global: each process owns ``local`` ranks, global rank =
process index x local + i, and each rank's random stream is folded from its
global rank, so a result depends on the rank count D and on nothing else
(not on how the ranks map to processes or devices).

The collectives (`_all_gather` and what reads its rank-major result: a
sum, a max, the first rank holding the maximum; `_broadcast0`) are plain
torch ops over the per-rank results within a process, and torch.distributed
calls on host copies of them across processes (gloo: two processes on one
card would share a GPU, which NCCL refuses). They move a few KB: a rank's
pool is keep_local x (1 + 16 + 16) floats. The JAX package promotes its
inputs to global arrays when the mesh spans processes (``_globalize``,
``_globalize_hyp``); this program has no global arrays, since every
process holds the packs whole and each rank reads them on its own device,
so neither has a counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import time
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import congruent, rng, sampling
from ..config import MatchConfig
from ..estimator import (
    _load_sweep_checkpoint,
    _pair_ep_of,
    _phase_fit,
    _phase_sample,
    _phase_sample_instance,
    _phase_score,
    _run_congruent,
    _save_sweep_checkpoint,
    _sweep_cfg_fingerprint,
    _to_host,
    finish_sweep_pool,
)
from ..model import ModelPack
from ..scene import ScenePack
from ..scoring import _top_k
from ..utils import trace
from ..utils.device import require
from ..utils.log import log_event, warn

HYP_AXIS = "hyp"


def process_count() -> int:
    """Processes of the torch.distributed group, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout: float = 300.0) -> int:
    """Join a torch.distributed group (the gloo backend, through
    init_method="tcp://<coordinator_address>"), configured by the
    arguments or, without them, by the environment torchrun sets
    (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK). A no-op returning 1
    when neither configures a group; a second call is a no-op too. A
    process that waits more than `timeout` seconds for the others raises.
    Returns the number of processes."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator_address is None:
        return 1
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout),
    )
    return dist.get_world_size()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of ranks: this process's `devices` (one a rank,
    repeats allowed), times `process_count` processes."""

    devices: Tuple[torch.device, ...]
    axis: str = HYP_AXIS
    process_index: int = 0
    process_count: int = 1

    @property
    def local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        return self.local * self.process_count

    def rank(self, i: int) -> int:
        """The global rank of this process's i-th rank."""
        return self.process_index * self.local + i


def _device(d) -> torch.device:
    dev = require(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices: Optional[Sequence] = None, axis: str = HYP_AXIS) -> Mesh:
    """This process's ranks, one a device of `devices` (default: every
    visible card); under torch.distributed the mesh spans every process of
    the group, each of which must give as many ranks."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            require("cuda")
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one rank")
    n_proc = process_count()
    if n_proc == 1:
        return Mesh(devices, axis)
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(n_proc)]
    dist.all_gather(counts, torch.tensor([len(devices)]))
    if len({int(c) for c in counts}) != 1:
        raise ValueError(f"the processes give different rank counts: "
                         f"{[int(c) for c in counts]}")
    return Mesh(devices, axis, dist.get_rank(), n_proc)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _flat(*tensors) -> torch.Tensor:
    """One float64 vector of the tensors (exact for int32 and float32)."""
    return torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])


def _all_gather(mesh: Mesh, parts, device) -> torch.Tensor:
    """[D, L]: the per-rank vectors `parts` [L] of every process, rank-major,
    on `device`. Its columns give the sums, maxima and the first rank
    holding a maximum (torch.argmax returns the first maximal index, as
    jnp.argmax does)."""
    local = torch.stack([p.to(device) for p in parts])
    if mesh.process_count == 1:
        return local
    trace.count("host_reads")
    host = local.cpu()
    out = [torch.empty_like(host) for _ in range(mesh.process_count)]
    dist.all_gather(out, host)
    return torch.cat(out).to(device)


def _broadcast0(mesh: Mesh, tensors):
    """Process 0's values of `tensors` in every process (the shapes agree
    everywhere)."""
    if mesh.process_count == 1:
        return list(tensors)
    out = []
    for t in tensors:
        trace.count("host_reads")
        host = t.cpu().to(torch.uint8 if t.dtype == torch.bool else t.dtype).contiguous()
        dist.broadcast(host, src=0)
        out.append(host.to(t.device, t.dtype))
    return out


def _on_ranks(mesh: Mesh, *values):
    """Each value (a pack or a tensor) on every rank's device, one copy a
    distinct device: a list with one tuple per local rank."""
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = tuple(None if v is None else v.to(d) for v in values)
    return [copies[d] for d in mesh.devices]


# ---------------------------------------------------------------------------
# one rank's share
# ---------------------------------------------------------------------------

def _phases_234(k_cong, model: ModelPack, scene: ScenePack, class_prob, bases,
                cfg: MatchConfig, coarse_to_fine: bool, d2_implied: bool,
                use_baked: bool):
    """Congruent -> fit -> score for one rank's (sampled) bases, with the
    fit-time compaction and the counters of the one-device phases.
    Returns (scores [H], transforms [H, 4, 4], world_transforms [H, 4, 4],
    valid [H], n_slot_valid, pair_max, shortfall)."""
    sets = _run_congruent(k_cong, model, scene, bases, cfg, d2_implied)
    cap = cfg.score_compact_cap if coarse_to_fine else 0
    poses, n_slot_valid = _phase_fit(
        scene.pos, _pair_ep_of(model), scene.centroid, model.centroid, bases,
        sets, compact_cap=cap,
    )
    slots = bases.valid.shape[0] * cfg.maximum_congruent_sets
    pre_n = torch.clamp(n_slot_valid, max=cap) if (cap and slots > cap) else None
    # the weights baked into the scene structures only under the pristine
    # prior they were built with (class path); the instance path scores
    # with the decayed prior, read explicitly
    sp = (None if use_baked and scene.field.has_probs and scene.grid.has_probs
          else class_prob)
    scores, _i, _b = _phase_score(poses, model, scene, sp, cfg, coarse_to_fine,
                                  precompacted_count=pre_n)
    return (scores, poses.transform, poses.world_transform, poses.valid,
            n_slot_valid, sets.pair_counts.max(),
            congruent.selection_shortfall(sets, cfg))


def _local_hypotheses(key_local, model: ModelPack, scene: ScenePack, class_prob,
                      bits, cfg: MatchConfig, b_local: int, coarse_to_fine: bool,
                      d2_implied: bool = False):
    """One rank's share of a class-path step: sample b_local bases, then
    phases 2-4. `bits` is the optional pair-existence matrix
    (sampling.build_exists_bits)."""
    k_sample, k_cong = rng.split(key_local)
    bases = _phase_sample(k_sample, model.table, scene.pos, scene.normal,
                          class_prob, scene.valid, cfg, b_local, bits)
    return _phases_234(k_cong, model, scene, class_prob, bases, cfg,
                       coarse_to_fine, d2_implied, use_baked=True)


def matching_step_sharded(mesh: Mesh, model: ModelPack, scene: ScenePack,
                          cfg: MatchConfig, key: torch.Tensor,
                          coarse_to_fine: bool = False,
                          allow_class_sampling: bool = False):
    """One full matching step over the mesh: each rank samples and runs
    number_of_bases / D bases under the key fold_in(key, rank). Returns
    (best_score, best_world_transform [4, 4], num_valid_hypotheses) as
    tensors on the scene's device: the winner is the first rank holding
    the largest local best, and its pose is taken whole.

    Class sampling only: an edge-mapped scene is refused (the sequential
    flood-fill sampler does not split over ranks; run_sweep_sharded
    samples it before splitting) unless the caller asks for class sampling
    with allow_class_sampling=True, which is warned."""
    if scene.has_edge:
        if not allow_class_sampling:
            raise ValueError(
                "matching_step_sharded cannot run the instance path on an "
                "edge-mapped scene (the sequential flood-fill sampler "
                "cannot live inside the shard body); use "
                "run_sweep_sharded (which samples outside the mesh) or "
                "the single-chip StocsEstimator, or pass "
                "allow_class_sampling=True to deliberately run CLASS "
                "sampling here"
            )
        warn(
            "matching_step_sharded on an edge-mapped scene is running "
            "CLASS sampling (allow_class_sampling=True); the reference's "
            "instance semantics live in run_sweep_sharded",
        )
    n_dev = mesh.size
    if cfg.number_of_bases % n_dev:
        raise ValueError(
            f"number_of_bases={cfg.number_of_bases} not divisible by mesh "
            f"size {n_dev}"
        )
    b_local = cfg.number_of_bases // n_dev
    d2 = congruent.d2_test_implied(model.pos, cfg)
    parts = []
    for i, (m, s) in enumerate(_on_ranks(mesh, model, scene)):
        scores, _t, world, valid, _nsv, _pm, _sh = _local_hypotheses(
            rng.fold_in(key, mesh.rank(i)), m, s, s.class_prob, None, cfg,
            b_local, coarse_to_fine, d2_implied=d2,
        )
        li = torch.argmax(scores)
        parts.append(_flat(scores[li], world[li], valid.sum(dtype=torch.int32)))
    g = _all_gather(mesh, parts, scene.pos.device)       # [D, 1 + 16 + 1]
    winner = torch.argmax(g[:, 0])
    return (g[winner, 0].to(torch.float32),
            g[winner, 1:17].reshape(4, 4).to(torch.float32),
            g[:, 17].sum().to(torch.int32))


def _pool_part(scores, transforms, world, valid, n_slot_valid, pair_max,
               shortfall, keep_local: int):
    """One rank's contribution to a sweep chunk: its top keep_local scores
    (values descending, ties by ascending index) with their transforms,
    and its counters, as one vector."""
    top, idx = _top_k(scores, min(keep_local, scores.shape[0]))
    return _flat(top, transforms[idx], world[idx], valid.sum(dtype=torch.int32),
                 n_slot_valid, pair_max, shortfall)


def _reduce_pools(g, k: int):
    """The gathered [D, k * 33 + 4] chunk parts -> the rank-major pool
    (scores [D * k], transforms and world transforms [D * k, 4, 4]) and the
    counters: valid hypotheses summed, the per-rank maxima of the
    congruent-valid slots and of the pair count, the shortfall summed."""
    s = g[:, :k].reshape(-1).to(torch.float32)
    t = g[:, k:17 * k].reshape(-1, 4, 4).to(torch.float32)
    w = g[:, 17 * k:33 * k].reshape(-1, 4, 4).to(torch.float32)
    c = g[:, 33 * k:].to(torch.int32)
    return s, t, w, c[:, 0].sum(dtype=torch.int32), c[:, 1].max(), c[:, 2].max(), \
        c[:, 3].sum(dtype=torch.int32)


def run_sweep_sharded(
    mesh: Mesh,
    model: ModelPack,
    scene: ScenePack,
    cfg: MatchConfig,
    total_bases: int,
    chunk: int = 2048,
    keep_per_chunk: Optional[int] = None,
    seed: Optional[int] = None,
    coarse_to_fine: bool = True,
    verbose: bool = True,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 8,
    stop_after_chunks: Optional[int] = None,
):
    """Large hypothesis sweep over the mesh: `total_bases` bases in chunks
    of `chunk`, each chunk split evenly over the D ranks; each rank keeps
    its top keep_per_chunk / D scored poses, the pools are gathered
    rank-major, and the pooled winners are ICP-polished and clustered
    (estimator.finish_sweep_pool). Same return shape as
    StocsEstimator.run_sweep: (best_lcp, best_world_transform,
    clustered_transforms, clustered_lcp, stats), stats with `devices`. A
    `total_bases` that is not a multiple of `chunk` is rounded up.

    Class path: chunk ci's key is fold_in(PRNGKey(seed), ci), rank r's
    fold_in(chunk key, r); every rank samples its own bases through the
    pair-existence matrix, built once. Edge-mapped scenes run the instance
    path: the sequential sampler (flood-fill segments, the decay carried
    across chunks) draws the whole chunk on the scene's device, exactly as
    the one-device sweep does, with (k_sample, k_cong) = split(chunk key);
    rank r takes bases [r * chunk / D, (r + 1) * chunk / D) and the
    congruent key fold_in(k_cong, r), and scores under the chunk's decayed
    prior. With several processes, every process samples and process 0's
    chunk state (bases, invariants, valid mask, decayed prior, fill
    convergence) is broadcast, so the processes cannot fork.

    `checkpoint_path` / `checkpoint_every` / `stop_after_chunks` as in
    run_sweep: the checkpoint (the one-device format, version 3) also
    records D, and resuming it under another D, or one-device, is refused
    (the rank streams would differ); a resume is bit-identical to the
    uninterrupted sweep."""
    use_instance = scene.has_edge
    n_dev = mesh.size
    if chunk % n_dev:
        raise ValueError(f"chunk={chunk} not divisible by mesh size {n_dev}")
    b_local = chunk // n_dev
    if keep_per_chunk is None:
        keep_per_chunk = cfg.sweep_keep_per_chunk
    if keep_per_chunk == 0:
        # keep every local hypothesis slot
        keep_per_chunk = b_local * cfg.maximum_congruent_sets * n_dev
    keep_local = max(1, keep_per_chunk // n_dev)
    n_chunks = -(-total_bases // chunk)
    cfg_chunk = dataclasses.replace(cfg, number_of_bases=chunk)
    seed_used = cfg.seed if seed is None else seed
    home = scene.pos.device

    key0 = rng.PRNGKey(seed_used)
    t_start = time.perf_counter()
    t_prev = 0.0
    class_prob = scene.class_prob
    bits = None if use_instance else sampling.build_exists_bits(
        model.table, scene.pos, scene.normal,
        cfg.ppf_tr_discretization, cfg.ppf_rot_discretization,
    )
    ranks = _on_ranks(mesh, model, scene, bits)
    d2 = congruent.d2_test_implied(model.pos, cfg)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=home)

    pool_s, pool_t, pool_w = [], [], []
    chunk_valid, chunk_slot_valid, pair_maxes = [], [], []
    shortfalls, unconverged = [], []
    start_chunk = 0
    resumed_unconverged = 0
    resumed_pair_max = 0
    cfg_fp = _sweep_cfg_fingerprint(cfg_chunk) if checkpoint_path else ""
    if checkpoint_path and os.path.exists(checkpoint_path):
        state = _load_sweep_checkpoint(
            checkpoint_path, chunk=chunk, seed=seed_used, kp=keep_per_chunk,
            cfg_fp=cfg_fp, use_instance=use_instance, device=home,
            devices=n_dev,
        )
        start_chunk = state["next_chunk"]
        if start_chunk > n_chunks:
            raise ValueError(
                f"sweep checkpoint {checkpoint_path} has already processed "
                f"{start_chunk} chunks; this call asks for only {n_chunks}"
            )
        if start_chunk:
            pool_s.append(state["pool_s"].reshape(-1))
            pool_t.append(state["pool_t"].reshape(-1, 4, 4))
            pool_w.append(state["pool_w"].reshape(-1, 4, 4))
            chunk_valid.extend(state["chunk_valid"].reshape(-1))
            chunk_slot_valid.extend(state["chunk_slot_valid"].reshape(-1))
        resumed_unconverged = state["unconverged"]
        resumed_pair_max = state["pair_max"]
        t_prev = state["elapsed"]
        if state["prob_decayed"]:
            class_prob = state["class_prob"]
        log_event("stocs_sweep_sharded_resume", path=checkpoint_path,
                  next_chunk=start_chunk, n_chunks=n_chunks, devices=n_dev)
        if verbose:
            print(f"sharded sweep: resumed from {checkpoint_path} at chunk "
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
            checkpoint_path, next_chunk=next_chunk, chunk=chunk,
            seed=seed_used, kp=keep_per_chunk, cfg_fp=cfg_fp,
            use_instance=use_instance, devices=n_dev,
            pool_s=torch.cat(pool_s).reshape(next_chunk, -1),
            pool_t=torch.cat(pool_t).reshape(next_chunk, -1, 4, 4),
            pool_w=torch.cat(pool_w).reshape(next_chunk, -1, 4, 4),
            chunk_valid=torch.stack(chunk_valid),
            chunk_slot_valid=torch.stack(chunk_slot_valid),
            unconverged=total(unconverged, resumed_unconverged),
            elapsed=t_prev + (time.perf_counter() - t_start),
            prob_decayed=class_prob is not scene.class_prob,
            class_prob=class_prob,
            pair_max=running_pair_max(),
        )

    stopped_at = None
    for ci in range(start_chunk, n_chunks):
        key = rng.fold_in(key0, ci)
        k_sample, k_cong = rng.split(key)
        parts = []
        if use_instance:
            # the sequential sampler on the whole chunk, as the one-device
            # sweep runs it: the same bases and decayed prior
            inst = _phase_sample_instance(k_sample, model.table, scene,
                                          class_prob, cfg_chunk, chunk)
            chunk_state = _broadcast0(mesh, (
                inst.indices, inst.invariant1, inst.invariant2, inst.valid,
                inst.class_prob, inst.fill_converged))
            del inst
            class_prob, fill_conv = chunk_state[4], chunk_state[5]
            unconverged.append((~fill_conv).sum(dtype=torch.int32))
            for i, ((m, s, _b), (bi, i1, i2, bv, cp)) in enumerate(zip(
                    ranks, _on_ranks(mesh, *chunk_state[:5]))):
                r = mesh.rank(i)
                blk = slice(r * b_local, (r + 1) * b_local)
                bases = sampling.SampledBases(bi[blk], i1[blk], i2[blk], bv[blk])
                parts.append(_pool_part(*_phases_234(
                    rng.fold_in(k_cong, r), m, s, cp, bases, cfg_chunk,
                    coarse_to_fine, d2, use_baked=False), keep_local))
        else:
            for i, (m, s, b) in enumerate(ranks):
                parts.append(_pool_part(*_local_hypotheses(
                    rng.fold_in(key, mesh.rank(i)), m, s, s.class_prob, b,
                    cfg_chunk, b_local, coarse_to_fine, d2_implied=d2),
                    keep_local))
        k = (parts[0].shape[0] - 4) // 33         # the pools' length
        s_, t_, w_, nv, slot_max, pair_mx, short = _reduce_pools(
            _all_gather(mesh, parts, home), k)
        pool_s.append(s_)
        pool_t.append(t_)
        pool_w.append(w_)
        # device-side counters, read once after the loop
        chunk_valid.append(nv)
        chunk_slot_valid.append(slot_max)
        pair_maxes.append(pair_mx)
        shortfalls.append(short)
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
    h_unconv, h_nvs, h_slvs, h_pmx, h_short = _to_host(
        total(unconverged, resumed_unconverged),
        torch.stack(chunk_valid) if chunk_valid else i32([0]),
        torch.stack(chunk_slot_valid) if chunk_slot_valid else i32([0]),
        running_pair_max(), total(shortfalls),
    )
    n_unconverged = int(h_unconv)
    if n_unconverged:
        warn(
            f"{n_unconverged} flood fills across the sharded sweep did not "
            f"reach their BFS fixpoint in flood_fill_sweeps="
            f"{cfg.flood_fill_sweeps} sweeps — segments under-fill",
            n_unconverged=n_unconverged, sweeps=cfg.flood_fill_sweeps,
        )
    n_hyp_total = int(h_nvs.sum())
    cap = cfg.score_compact_cap
    slots_local = b_local * cfg.maximum_congruent_sets
    slot_max = int(h_slvs.max())
    if coarse_to_fine and cap and slots_local > cap and slot_max > cap:
        warn(
            f"a device's chunk shard produced {slot_max} "
            f"congruent-valid hypothesis slots, over "
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
    extra = {"devices": n_dev, "completed": completed}
    if has_pair_max:
        extra["pair_count_max"] = pair_max
    if not completed:
        extra["next_chunk"] = stopped_at
    return finish_sweep_pool(
        torch.cat(pool_s), torch.cat(pool_t), torch.cat(pool_w), model, scene,
        class_prob, cfg, total_bases=processed, n_hyp_total=n_hyp_total,
        t_start=t_start - t_prev, verbose=verbose, event="stocs_sweep_sharded",
        extra_stats=extra,
    )
