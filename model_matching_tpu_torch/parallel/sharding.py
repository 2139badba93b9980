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

Under torchrun (one process a card) each process binds itself to the card
``LOCAL_RANK`` names (``init_distributed``, ``local_card``), and a mesh made
without devices is that one card (``default_devices``): four processes on
four cards make a mesh of four ranks. A lone process keeps every visible
card, and runs its ranks' shares one after another, which is slower than
one card: launch multi-card sweeps with torchrun (``torchrun_env`` gives a
process started by hand the same environment).

The collectives (`_all_gather` and what reads its rank-major result: a
sum, a max, the first rank holding the maximum; `_broadcast0`) are plain
torch ops over the per-rank results within a process, and torch.distributed
calls on host copies of them across processes. They move a few KB: a
rank's pool is keep_local x (1 + 16 + 16) floats. The group is gloo's
because processes may share a card (``dcn_worker.launch(2, 1)`` runs two on
one), which NCCL refuses; that reason holds only for processes that share
a card. Under torchrun, one process a card, gloo stays because the
exchange is small: its host copy ends on a device synchronize that each
chunk's gather needs anyway. The spans `sweep.gather` and
`sweep.broadcast` and the counters `sharding.collectives` and
`sharding.collective_bytes` (the bytes this process sent) show what the
exchange costs.

The JAX package promotes its inputs to global arrays when the mesh spans
processes (``_globalize``, ``_globalize_hyp``); this program has no global
arrays, since every process holds the packs whole and each rank reads
them on its own device, so neither has a counterpart here.
"""

from __future__ import annotations

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
    _phase_sample,
    _phase_sample_instance,
    _phases_234,
    _sweep_chunks,
    _SweepChunk,
)
from ..model import ModelPack
from ..scene import ScenePack
from ..scoring import _top_k
from ..utils import trace
from ..utils.device import require
from ..utils.log import warn

HYP_AXIS = "hyp"


def process_count() -> int:
    """Processes of the torch.distributed group, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_card(env, n_cards: int) -> Optional[int]:
    """The card a process of a torchrun group takes: ``LOCAL_RANK`` (from
    the mapping `env`) modulo the `n_cards` cards in sight. None without a
    ``LOCAL_RANK`` or without a card."""
    local = env.get("LOCAL_RANK")
    if local is None or n_cards <= 0:
        return None
    return int(local) % n_cards


def _card_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_devices() -> list:
    """This process's ranks when none are given: in a torchrun group of
    more than one process, one rank, the card ``local_card`` names;
    otherwise every visible card. Raises without a card."""
    n = _card_count()
    if n == 0:
        require("cuda")
    if process_count() > 1 and "LOCAL_RANK" in os.environ:
        return [torch.device("cuda", local_card(os.environ, n))]
    return [torch.device("cuda", i) for i in range(n)]


def process_devices(dev: torch.device) -> list:
    """The ranks of this process on device `dev`, as the CLI's --sweep
    shards over them: ``default_devices()`` on the card, `dev` alone on
    the CPU."""
    return default_devices() if dev.type == "cuda" else [dev]


def torchrun_env(port: int, world: int, rank: int) -> dict:
    """The variables torchrun gives process `rank` of `world` on one host
    whose rendezvous is localhost:`port`: MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE, and OMP_NUM_THREADS 1
    unless the caller's environment sets it (torchrun's default for several
    processes a host)."""
    return {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": str(world),
            "RANK": str(rank), "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
            "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "1")}


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout: float = 300.0) -> int:
    """Join a torch.distributed group (the gloo backend, through
    init_method="tcp://<coordinator_address>"), configured by the
    arguments or, without them, by the environment torchrun sets
    (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK). A no-op returning 1
    when neither configures a group; a second call is a no-op too. A
    process that waits more than `timeout` seconds for the others, at the
    rendezvous or in a collective, raises. A process that joins a group
    with ``LOCAL_RANK`` in its environment is bound to the card
    ``local_card`` names (``torch.cuda.set_device``), so that the default
    ``cuda`` device of its ingest, packs and kernels is its own card.
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
    card = local_card(env, _card_count())
    if card is not None:
        torch.cuda.set_device(card)
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
    """This process's ranks, one a device of `devices` (default:
    ``default_devices()``, the bound card in a torchrun group, every visible
    card otherwise); under torch.distributed the mesh spans every process
    of the group, each of which must give as many ranks."""
    if devices is None:
        devices = default_devices()
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one rank")
    n_proc = process_count()
    if n_proc == 1:
        return Mesh(devices, axis)
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(n_proc)]
    mine = torch.tensor([len(devices)])
    _count_sent(mine)
    dist.all_gather(counts, mine)
    if len({int(c) for c in counts}) != 1:
        raise ValueError(f"the processes give different rank counts: "
                         f"{[int(c) for c in counts]}")
    return Mesh(devices, axis, dist.get_rank(), n_proc)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _count_sent(host: torch.Tensor) -> None:
    """Count one collective call and the bytes this process sends in it."""
    trace.count("sharding.collectives")
    trace.count("sharding.collective_bytes", host.numel() * host.element_size())


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
    _count_sent(host)
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
        if mesh.process_index == 0:
            _count_sent(host)
        else:
            trace.count("sharding.collectives")
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
                       coarse_to_fine, d2_implied)


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
    counters: each rank's valid hypotheses [D], the per-rank maxima of the
    congruent-valid slots and of the pair count, the shortfall summed."""
    s = g[:, :k].reshape(-1).to(torch.float32)
    t = g[:, k:17 * k].reshape(-1, 4, 4).to(torch.float32)
    w = g[:, 17 * k:33 * k].reshape(-1, 4, 4).to(torch.float32)
    c = g[:, 33 * k:].to(torch.int32)
    return s, t, w, c[:, 0], c[:, 1].max(), c[:, 2].max(), c[:, 3].sum(dtype=torch.int32)


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
    clustered_transforms, clustered_lcp, stats), stats with `best_chunk`
    and `best_refined` as run_sweep's, `devices`,
    `rank_hypotheses` (each global rank's valid hypotheses as the pools'
    reduction took them in) and `local_hypotheses` (this process's ranks'
    own counts, before the gather), both over the chunks of this call. A
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
    uninterrupted sweep.

    Spans, under the names run_sweep uses: `sweep.run` around the call,
    `sweep.chunk` around each chunk, `sweep.finish` around the tail; inside
    a chunk `sweep.gather` (the gather through the pool's reduction: across
    processes it ends on a host copy, so it holds the wait for the slowest
    process) and, on the instance path, `sweep.sample` (the sampler, ending
    on a synchronize) and `sweep.broadcast`."""
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
    cfg_chunk = dataclasses.replace(cfg, number_of_bases=chunk)
    home = scene.pos.device

    def step(key, prior):
        k_sample, k_cong = rng.split(key)
        parts, unconverged = [], None
        if use_instance:
            # the sequential sampler on the whole chunk, as the one-device
            # sweep runs it: the same bases and decayed prior
            with trace.span("sweep.sample", sync=home):
                inst = _phase_sample_instance(k_sample, model.table, scene, prior,
                                              cfg_chunk, chunk)
            with trace.span("sweep.broadcast"):
                chunk_state = _broadcast0(mesh, (
                    inst.indices, inst.invariant1, inst.invariant2, inst.valid,
                    inst.class_prob, inst.fill_converged))
            del inst
            prior, fill_conv = chunk_state[4], chunk_state[5]
            unconverged = (~fill_conv).sum(dtype=torch.int32)
            for i, ((m, s, _b), (bi, i1, i2, bv, cp)) in enumerate(zip(
                    ranks, _on_ranks(mesh, *chunk_state[:5]))):
                r = mesh.rank(i)
                blk = slice(r * b_local, (r + 1) * b_local)
                bases = sampling.SampledBases(bi[blk], i1[blk], i2[blk], bv[blk])
                parts.append(_pool_part(*_phases_234(
                    rng.fold_in(k_cong, r), m, s, cp, bases, cfg_chunk,
                    coarse_to_fine, d2), keep_local))
        else:
            for i, (m, s, b) in enumerate(ranks):
                parts.append(_pool_part(*_local_hypotheses(
                    rng.fold_in(key, mesh.rank(i)), m, s, s.class_prob, b,
                    cfg_chunk, b_local, coarse_to_fine, d2_implied=d2),
                    keep_local))
        k = (parts[0].shape[0] - 4) // 33         # the pools' length
        local_valid = torch.stack([p[33 * k].to(home) for p in parts])
        with trace.span("sweep.gather"):
            s_, t_, w_, nv, slot_max, pair_mx, short = _reduce_pools(
                _all_gather(mesh, parts, home), k)
        return _SweepChunk(s_, t_, w_, nv.sum(dtype=torch.int32), slot_max,
                           pair_mx, short, prior, unconverged,
                           counts={"rank_hypotheses": nv,
                                   "local_hypotheses": local_valid})

    def zeros(n):
        return torch.zeros(n, dtype=torch.int32, device=home)

    with trace.span("sweep.run"):
        t_start = time.perf_counter()
        bits = None if use_instance else sampling.build_exists_bits(
            model.table, scene.pos, scene.normal,
            cfg.ppf_tr_discretization, cfg.ppf_rot_discretization,
        )
        ranks = _on_ranks(mesh, model, scene, bits)
        d2 = congruent.d2_test_implied(model.pos, cfg)
        # the tail scores under the explicit prior, the baked weights unread
        return _sweep_chunks(
            step, model, scene, cfg_chunk, scene.class_prob,
            total_bases=total_bases, chunk=chunk,
            seed=cfg.seed if seed is None else seed, kp=keep_per_chunk,
            t_start=t_start, verbose=verbose, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, stop_after_chunks=stop_after_chunks,
            coarse_to_fine=coarse_to_fine, devices=n_dev,
            counts={"rank_hypotheses": zeros(n_dev), "local_hypotheses": zeros(mesh.local)},
            baked_finish=False,
        )[0]
