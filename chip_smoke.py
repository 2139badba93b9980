"""Drive the PyTorch port of STOCS on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and prints no result:

1. device  — a CUDA device is required; prints the card's name and power
             limit as nvidia-smi reports them.
2. build   — builds the port's CUDA kernels from model_matching_tpu_torch/csrc
             (one nvcc per source, in parallel) and prints nvcc's register
             and shared-memory lines.
3. kernel  — the dense congruent gate kernel against its plain torch version
             on the card, at the main path's dense-tier shapes, with the
             distance test on and off, all tiles live and a random live
             mask, and partial valid-lane counts; then the dense tier of a
             pack without endpoint rows (5,000-column Q tiles, 8 stripes)
             with the cone test off and with one cell (the radius mode);
             then cell distributions that could break the kernel's bucketed
             scan (one cell, all cells distinct, ids equal in their low 6 or
             16 bits) at 2,600-column Q tiles with 8 stripes and valid lanes
             that end inside a slab: outputs must be equal bit for bit. The
             main-path shapes are timed warm (CUDA events, 10 runs). After
             phase 4, every dense-gate launch that its warm-up run recorded
             is checked the same way and the largest one is timed.
4. main    — the class-path estimator at a realistic YCB size (480 model
             points, 16,384 scene points, 100 bases x 200 sets, 20,480
             pairs per bin: full recall) on the card: a warm-up run (which
             records the arguments of its dense-gate launches and the tables
             and indices of its row gathers), then
             a timed run with both kernels' launch counts reset just before
             it (and two more runs for the spread of the wall time).
             The timed run must launch both kernels, score best_lcp > 0.4, and
             pose the model onto the scene (median nearest-neighbor distance
             < 1.5 x distance_threshold).
5. reference — the port on the card against the port on the CPU (plain
             dense gate) at 4,096 scene points, 16 bases, 8,192 pairs per
             bin: the same best index, valid hypotheses and scored leaders,
             every hypothesis's LCP and best_lcp within 1e-5, and the pose
             within 1e-4.
6. row_gather — the row-gather kernel against its plain torch version on
             the card, bit for bit: the TPU probe's four shapes (f32
             [rows, 128]), every gather of phase 4's warm-up run (the
             dense-field rows, C = 8, and the payload rows, [R, cap * 8],
             with the run's own indices), int32 and int64 indices, and a
             misaligned table (the scalar path). Each is timed warm (CUDA
             events) beside the plain version and torch.index_select.
7. files   — the command-line path at full width on the card: a 640x480
             synthetic RGB-D scene and its object's source PLY written to
             build/chip_smoke_files/, then cli.main(["model-preprocess",
             ...]) and cli.main(["stocs-single", ...]) at the ycb preset's
             defaults (100 bases, 16,384 scene points), with both kernels'
             launch counts reset just before. Requires |S| > 3,000, both
             kernels launched, an orthonormal 3x4 pose whose posed model
             lies on the ingested scene (median nearest-neighbor distance
             < 1.5 x distance_threshold), and load_scene on the card equal
             to load_scene on the CPU (valid mask, positions, normals and
             probabilities bit for bit). Prints ingest and per-phase times.

8. instance — the instance path at full width on the card: the same
             640x480 scene with probability_maps/edge.png (the silhouette
             boundary and a line across the background), written to
             build/chip_smoke_instance/, through cli.main(["stocs-single",
             ..., "--cluster", "--heatmap"]) at the ycb preset's defaults,
             with both kernels' launch counts reset just before and every
             dense-gate launch and row gather recorded. Requires: the scene
             loads has_edge; both kernels launched; an orthonormal pose
             whose posed model lies on the ingested scene; the segment
             masks, clusters, heatmap and overlay written; then, from the
             sampler on the ingested scene (100 bases): the prior decayed
             (some valid point below its ingested value, none above), every
             valid base's four points inside its own segment mask and none
             on an edge pixel, the count of unconverged fills printed, and
             the sampler timed warm. Every sampler call, the command's
             included, must replay 99 of its 100 bases from the 3 CUDA
             graphs it captures and launch the base-rounds kernels twice a
             base (`base_rounds.launches`); sample_bases seconds and the
             counters are printed. The recorded launches
             are held against the plain versions bit for bit (the dense
             gate on the first two and the last base of a launch). Then at 160x120, 16 bases, a 1 cm
             voxel, 4,096 points, 2,048 pairs per bin and 64 sets per base
             the port on the card against the port on the CPU: equal
             sampled bases, segment masks and decayed prior, the same best
             index, LCP within 1e-5.
9. sweep   — the class scene of phase 7 through cli.main(["stocs-single", ...,
             "--sweep", "4096", "--sweep-chunk", "2048", "--cluster",
             "--heatmap"]), once uninterrupted (launch counts reset just
             before), then with --sweep-checkpoint and --sweep-stop-after 1
             (this one-chunk run's dense-gate launches and row gathers are
             recorded) and once more to resume. Requires: both kernels
             launched; the bit-packed existence matrix built in each call;
             the pose file and nothing else written (no cluster file,
             heatmap or overlay: the JAX package's command drops --cluster
             and --heatmap under --sweep); the resumed pose file equal to
             the uninterrupted one byte for byte and the clusters that
             run_sweep returned equal bit for bit; the checkpoint written,
             then removed; the best pose on the scene; at least one
             cluster, in descending LCP, the first being the pool's best;
             pair_count_max within max_pairs_per_bin or the warning logged.
             The recorded launches are held against the plain versions as
             in phase 8; the largest dense-gate launch and each distinct
             gather are timed. Prints bases/s and hypotheses/s.
10. multi  — three objects at full width: the 640x480 three-object scene of
             synthetic.write_synthetic_multi_scene (three distinct shells,
             each with its own probability map) written to
             build/chip_smoke_multi/, cli.main(["model-preprocess", ...]) for
             each object, then cli.main(["stocs-multi", ...]) at the ycb
             preset's defaults on the class scene and on the same scene with
             edge.png (the instance path), launch counts reset just before
             each; the class run's dense-gate launches and row gathers are
             recorded. Requires: both kernels launched on both paths; every
             object's pose file orthonormal, equal to a direct
             multi.match_all_objects call on the ingested packs, and its
             posed model within 1.5 x distance_threshold (median NN) of its
             own object's scene points; the recorded launches equal to the
             plain versions (first two and last base of a launch); object 0
             alone equal to its row, and each row unchanged when the other
             objects' priors are zeroed, bit for bit; the card against the
             CPU at 160x120 on the small configuration of
             tests/test_torch_cli.py (1 cm voxel, 4,096 points, 2,048 pairs
             per bin, 64 sets, 16 bases): equal hypothesis counts, LCP within
             1e-5, poses within 1e-4. Prints the command's wall, the warm
             call's and each object's alone.
11. commands — on phase 10's files: cli.main(["stocs-single", ...]) for each
             object (timed: the three one-object calls beside stocs-multi),
             ["stocs-batch", ...] whose pose files must equal them byte for
             byte; `serve` in a fresh process (python -m
             model_matching_tpu_torch.cli serve) answering four requests
             (two objects, the edge scene, a bad line) with OK rows within
             1e-4 of the stocs-single files (serve loads the packs
             standardized, as the JAX package's serve does) and the first
             equal to the estimator's on the standardized pack byte for
             byte, and no kernel load or build after the first request (its
             serve_request events; first and warm latency printed);
             ["eval", ...] of the stocs-multi and the stocs-single poses
             against the written ground truth (pose files and the BOP
             scene_gt.json) passing ADD-S for every object; ["stocs-single",
             ..., "--profile", DIR] writing a Chrome trace that names both
             kernels.
12. sharded — parallel/sharding.py at full width on the card, eight ranks
             on cuda:0: run_sweep_sharded on phase 7's class scene (4096
             bases in chunks of 2048, 256 bases a rank a chunk) beside phase
             9's one-device sweep of the same scene, launch counts reset just
             before the sharded run and its dense-gate launches and row
             gathers recorded and held against the plain versions (as in
             phase 8); its pose on the scene, its clusters in order; stopped
             after a chunk, refused by a 4-rank resume, resumed equal to the
             uninterrupted sweep bit for bit; an instance-path sharded sweep
             on phase 8's edge scene (256 bases, 8 ranks: a depth cut),
             launching both kernels, its pose on the scene;
             dcn_worker.launch(2, 1) with --device cuda (two processes
             joined over gloo on this card) whose results equal each other
             and a one-process run of 2 ranks; match_all_objects over 2
             ranks (three objects padded to four) equal to mesh=None bit for
             bit on phase 10's class scene; native.available() and
             model-preprocess timed with the host C++ helpers and with
             MM_NO_NATIVE=1 (the same ppf_table.npz).

13. fmath  — runs right after phase 2: ops/fmath.py's float32 atan2, atan,
             acos, asin, sin, cos, log, log2 and pow on the card against the CPU
             over 1,000,003 seeded inputs each (the call sites' domains)
             plus the edge cases (signed zeros, +-1 and neighbours, tiny,
             denormals, infinities, NaN, large arguments), atan2 and pow
             also over every pair of edge values (pow over the block
             decay's bases in (0, 1] with integer exponents 0..256 and over
             random finite pairs), and fp.xla_sum0 (the scene
             centroid's sum): equal bits required. Each function's call
             time and operator count (a kernel each) are printed beside
             torch's own call.

14. presets — runs last: the packed and linemod presets at full width.
             Packed: the 640x480 bin of eight boxes of
             synthetic.write_synthetic_packed_scene (edge.png along the box
             boundaries: the instance path) written to
             build/chip_smoke_packed/, cli.main(["model-preprocess", ...,
             "--preset", "packed"]) (the box's densest PPF bin union printed
             and required above the 16,384-pair tier), then
             ["stocs-single", ..., "--preset", "packed"] with both kernels'
             launch counts reset just before and the sampler's, congruent
             step's and dense gate's inputs and outputs recorded. Requires:
             both kernels launched; a dense-gate launch at P=Q=26,112 with
             a live mask that has dead tiles (its live share printed); the
             pose on the scene and on one of the boxes; every dense-gate
             launch equal to the plain version (first two and last base)
             and timed beside its bound; the sampler's 100 bases, 99 of
             them replayed from its 3 CUDA graphs, with 200 base-rounds
             launches (sample_bases seconds and the counters printed); two top-tier bases alone (one-base
             launches run blocks of 112 rows, which straddle a live and a
             dead 256-row P tile) equal too; every row gather equal to its
             plain version; at full width the sampler on the CPU equal to
             the card's (bases, masks, decayed prior) and congruent
             extraction on the CPU, its dense gate replaced by the card's
             outputs once its inputs (sorted cells, features, live masks)
             were found equal, giving the card's pairs, totals and
             selection_shortfall; the whole run card against CPU at 160x120
             with 8,192 pairs per bin (banded, two Q chunks): the same
             bases, masks, prior, congruent sets and best index, LCP within
             1e-5, pose within 1e-4. Then one 2,048-base chunk of
             ["--sweep", "2048", "--sweep-chunk", "2048", "--cluster"]
             (bases/s and each step's ms a base printed; its launches
             checked; the pose on a box); an estimator run with
             instance_block_size=8 (a decay exponent of at least 2; its
             decayed prior and masks equal to the CPU sampler's bit for
             bit; sampling's ms and operators dispatched a base beside
             block size 1, whose graph replays dispatch none).
             Linemod: the shell written in millimetres
             (synthetic.write_synthetic_scene(preset="linemod")) to
             build/chip_smoke_linemod/, model-preprocess and stocs-single
             at the preset: both kernels launched, ingest card == CPU bit
             for bit, the pose on the scene and its ADD-S under 10% of the
             diameter (`eval --model-scale 0.001`), the launches checked.

The line before the last is a JSON object describing the kernels (their
`launches` are those of phase 7's run; `launches_instance`,
`launches_sweep`, `launches_multi`, `launches_multi_edge`,
`launches_sharded`, `launches_sharded_instance`, `launches_packed`,
`launches_packed_sweep`, `launches_packed_block8` and `launches_linemod`
those of phases 8-10, 12 and 14); the last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import shutil
import subprocess
import sys
import time

# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM3
# bandwidth, and float32 outside the tensor cores
_HBM_BYTES_PER_S = 3.35e12
_FP32_OPS_PER_S = 67e12
_ROOT = os.path.dirname(os.path.abspath(__file__))
_START = time.perf_counter()


# the in-memory main path: the size bench.py of the JAX package calls
# realistic YCB, at full recall
MAIN_SETUP = dict(num_model=480, num_scene=16384, num_bases=100,
                  max_pairs=20480, max_congruent=200, seed=3)


def _phase(name):
    print(f"== {name} (at {time.perf_counter() - _START:.1f} s)", flush=True)


def _gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _gate_inputs(torch, gen, b, p, q, q_tile, dev, cell_kind=None):
    """Seeded dense-gate inputs: a small cell vocabulary so the gate passes
    often (or one of synthetic.GATE_CELL_CASES), valid-first lanes with
    partial counts, a random live mask."""
    rng = None
    if cell_kind is not None:
        import numpy as np

        from model_matching_tpu_torch.synthetic import gate_cells

        rng = np.random.default_rng(
            int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen)))

    def side(n, tag, count):
        e = torch.randn(b, 3, n, generator=gen) * 0.05
        d = torch.randn(b, 3, n, generator=gen)
        d = d / d.norm(dim=1, keepdim=True)
        sq = (e * e).sum(1, keepdim=True)
        feat = torch.cat([e, d, sq, torch.zeros(b, 1, n)], dim=1)
        cell = torch.randint(0, 8, (b, n), generator=gen, dtype=torch.int32)
        if cell_kind is not None:
            cell = torch.from_numpy(np.stack([gate_cells(cell_kind, rng, n)
                                              for _ in range(b)]))
        ok = torch.arange(n)[None, :] < count[:, None]
        cell = torch.where(ok, cell, tag).to(torch.int32)
        r = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, n), generator=gen,
                          dtype=torch.int64).to(torch.int32)
        return feat, cell, r

    p_count = torch.tensor([p, p // 3 + 7, 1][:b], dtype=torch.int32)
    q_count = torch.tensor([q, q // 2 + 5, 0][:b], dtype=torch.int32)
    pf, pc, rp = side(p, -1, p_count)
    qf, qc, rq = side(q, -2, q_count)
    alpha = torch.rand(b, generator=gen) * 2 - 1
    live = (torch.rand(b, -(-p // 256), q // q_tile, generator=gen) > 0.3).to(torch.int32)
    return [t.to(dev).contiguous() for t in
            (pf, qf, pc, qc, rp, rq, alpha, p_count, q_count, live)]


def _gate_equal(torch, dense_gate, dense_gate_reference, args, kw, where):
    """Kernel == plain version bit for bit on one set of arguments; returns
    (the largest absolute difference found, the number of matches)."""
    got = dense_gate(*args, **kw)
    ref = dense_gate_reference(*args, **kw)
    torch.cuda.synchronize()
    err = 0
    for g, r, what in zip(got, ref, ("row_best", "counts")):
        err = max(err, int((g.long() - r.long()).abs().max()))
        if not torch.equal(g, r):
            raise AssertionError(
                f"dense_gate {what} differs from the plain version at {where}: "
                f"{int((g != r).sum())} elements, largest difference {err}")
    return err, int(ref[1].sum(dtype=torch.int64))


def _time_ms(torch, fn, runs=10):
    """Milliseconds per call of `runs` calls made back to back (CUDA
    events): what a caller pays, the larger of the host's time to enqueue a
    call and the device's time to run it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / runs


def _device_ms(torch, fn, runs=10):
    """Milliseconds of device time per call: the calls are enqueued behind a
    few milliseconds of spinning on the device, so that they run back to
    back however long the host takes to enqueue each."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(8_000_000)
    start.record()
    for _ in range(runs):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / runs


def main() -> int:
    import torch

    # ---- 1. device
    _phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs the port on a GPU")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(_gpu_name_and_limit())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")

    from model_matching_tpu_torch.ops import _build
    from model_matching_tpu_torch.ops.dense_gate import (
        dense_gate,
        dense_gate_reference,
    )
    from model_matching_tpu_torch.ops.row_gather import row_gather
    from model_matching_tpu_torch.utils import trace

    # ---- 2. build
    _phase("build")
    t0 = time.perf_counter()
    _build.load()
    nvcc = [e.seconds for e in trace.snapshot().entries
            if e.kind == "span" and e.name == "kernels.build"]
    print(f"build_seconds {time.perf_counter() - t0:.3f} "
          f"(nvcc {nvcc[-1] if nvcc else None})")
    print("\n".join(l for l in _build.build_log.splitlines()
                    if "Used" in l or "spill" in l or "Compiling entry" in l))

    # ---- 13. the port's transcendentals: the card against the CPU
    _phase("fmath")
    _fmath_phase(torch, dev)

    # ---- 3. kernel against plain, on the card
    _phase("kernel")
    gen = torch.Generator().manual_seed(0)
    tol, thr, rand_mask, marker = 0.3, 0.01, 0x7FFF8000, 1 << 15
    shapes = [(4608, 4608), (8704, 4352), (17408, 4352), (21760, 4352)]
    per_shape = []
    max_err = 0
    for p, q_tile in shapes:
        inp = _gate_inputs(torch, gen, 3, p, p, q_tile, dev)
        pf, qf, pc, qc, rp, rq, alpha, p_count, q_count, live = inp
        for skip in (True, False):
            for lv in (None, live):
                kw = dict(q_tile=q_tile, skip_dist=skip, p_count=p_count,
                          q_count=q_count, live=lv)
                args = (pf, qf, pc, qc, rp, rq, alpha, tol, thr, rand_mask, marker)
                err, n_match = _gate_equal(
                    torch, dense_gate, dense_gate_reference, args, kw,
                    f"P=Q={p} skip_dist={skip} live={lv is not None}")
                max_err = max(max_err, err)
                if n_match == 0:
                    raise AssertionError(f"no gate match at P={p}: vacuous check")
        # time one base per launch, all lanes valid, distance test skipped
        # (the main path's setting)
        one = [t[:1].contiguous() for t in inp]
        pf1, qf1, pc1, qc1, rp1, rq1, al1 = one[:7]
        full = torch.tensor([p], dtype=torch.int32, device=dev)
        kw = dict(q_tile=q_tile, skip_dist=True, p_count=full, q_count=full)
        args = (pf1, qf1, pc1, qc1, rp1, rq1, al1, tol, thr, rand_mask, marker)
        ms = _device_ms(torch, lambda: dense_gate(*args, **kw))
        call_ms = _time_ms(torch, lambda: dense_gate(*args, **kw))
        plain_ms = _time_ms(torch, lambda: dense_gate_reference(*args, **kw))
        row = {"p": p, "q": p, "q_tile": q_tile, "ms": ms, "call_ms": call_ms,
               "plain_ms": plain_ms}
        row.update(_gate_bound(torch, dense_gate_reference, args, kw, ms))
        per_shape.append(row)
        print(f"dense_gate P=Q={p} q_tile={q_tile}: equal in 4 cases; one base "
              f"kernel {ms:.4f} ms on the device ({call_ms:.4f} ms a call back "
              f"to back), plain {plain_ms:.4f} ms; {_bound_text(row)}")
    # the dense tiers of other configurations: a model pack without
    # endpoint rows at max_pairs_per_bin=20000 (Q tiles of 5,000 columns, 8
    # stripes, partial P tiles and Q sub-tiles), the cone test off (a
    # negative cos tolerance) and the radius distance mode (one cell)
    p, q_tile = 20000, 5000
    inp = _gate_inputs(torch, gen, 3, p, p, q_tile, dev)
    pf, qf, pc, qc, rp, rq, alpha, p_count, q_count, live = inp
    one_cell = [torch.where(c >= 0, 0, c).contiguous() for c in (pc, qc)]
    for cells, check_cos, lv in (((pc, qc), True, live), ((pc, qc), False, None),
                                 (one_cell, True, None)):
        kw = dict(q_tile=q_tile, skip_dist=False, p_count=p_count,
                  q_count=q_count, live=lv, n_sub=8, check_cos=check_cos)
        args = (pf, qf, *cells, rp, rq, alpha, tol, thr, rand_mask, marker)
        err, n_match = _gate_equal(
            torch, dense_gate, dense_gate_reference, args, kw,
            f"P=Q={p} q_tile={q_tile} n_sub=8 check_cos={check_cos}")
        max_err = max(max_err, err)
        if n_match == 0:
            raise AssertionError(f"no gate match at P={p}: vacuous check")
    print(f"dense_gate P=Q={p} q_tile={q_tile} n_sub=8: equal in 3 cases "
          f"(live mask; cone test off; one cell)")
    # cell distributions that could break a bucketed scan; 2,600-column Q
    # tiles (two slabs of 1,300), 8 stripes of 325, a partial P tile, and
    # valid Q lanes that end inside a slab (q_count 3,905 and 5)
    from model_matching_tpu_torch.synthetic import GATE_CELL_CASES

    p, q, q_tile = 3000, 5200, 2600
    for dist in GATE_CELL_CASES:
        inp = _gate_inputs(torch, gen, 2, p, q, q_tile, dev, cell_kind=dist)
        pf, qf, pc, qc, rp, rq, alpha, p_count, q_count, live = inp
        q_count = torch.tensor([3905, 5], dtype=torch.int32, device=dev)
        qc = torch.where(torch.arange(q, device=dev)[None, :] < q_count[:, None],
                         qc.clamp(min=0), -2).to(torch.int32).contiguous()
        for skip, lv in ((True, None), (False, live)):
            kw = dict(q_tile=q_tile, skip_dist=skip, p_count=p_count,
                      q_count=q_count, live=lv, n_sub=8)
            args = (pf, qf, pc, qc, rp, rq, alpha, tol, thr, rand_mask, marker)
            err, n_match = _gate_equal(
                torch, dense_gate, dense_gate_reference, args, kw,
                f"cells {dist} P={p} Q={q} skip_dist={skip} live={lv is not None}")
            max_err = max(max_err, err)
            if n_match == 0:
                raise AssertionError(f"no gate match on cells {dist}: vacuous check")
    print(f"dense_gate P={p} Q={q} q_tile={q_tile} n_sub=8: equal on the cell "
          f"distributions {', '.join(GATE_CELL_CASES)} (2 cases each)")

    # ---- 4. main path
    _phase("main")
    from model_matching_tpu_torch.estimator import StocsEstimator
    from model_matching_tpu_torch.synthetic import synthetic_arrays, synthetic_setup

    model, scene, cfg = synthetic_setup(**MAIN_SETUP, device=dev)
    est = StocsEstimator(model, scene, cfg)
    # the warm-up run records the dense-gate launches' arguments and the row
    # gathers' tables and indices (the kernels are checked and timed on
    # them below and in phase 6); the counted run goes without recording
    gathers = _record_gathers(scene)
    gates = _record_gates()
    t0 = time.perf_counter()
    est.run(verbose=False)
    print(f"warm-up run {time.perf_counter() - t0:.3f} s")
    gathers.stop()
    gates.stop()
    k_before = _kernel_launches()
    t0 = time.perf_counter()
    res = est.run(verbose=False)
    wall = time.perf_counter() - t0
    n = _kernel_launches(k_before)
    launches, gather_launches = n["dense_gate_launches"], n["row_gather_launches"]
    print(f"timed run {wall:.4f} s; best_index {res.best_index} best_lcp "
          f"{res.best_lcp:.6f}; bases {res.num_bases} hypotheses "
          f"{res.num_hypotheses}; dense_gate launches {launches}; row_gather "
          f"launches {gather_launches}")
    print("timings_ms " + json.dumps(
        {k: round(v * 1e3, 3) for k, v in res.timings.items()}))
    print("stats " + json.dumps(res.stats))
    walls = [wall]
    for _ in range(2):
        t0 = time.perf_counter()
        est.run(verbose=False)
        walls.append(time.perf_counter() - t0)
    walls.sort()
    print(f"3 timed runs: median {walls[1] * 1e3:.3f} ms, min "
          f"{walls[0] * 1e3:.3f} ms, max {walls[-1] * 1e3:.3f} ms")
    if launches <= 0:
        raise AssertionError("the main path never launched the dense-gate kernel")
    if gather_launches <= 0:
        raise AssertionError("the main path never launched the row-gather kernel")
    if res.stats["pair_count_max"] > cfg.max_pairs_per_bin:
        raise AssertionError("PPF pair lists were truncated: not full recall")
    if not res.best_lcp > 0.4:
        raise AssertionError(f"best_lcp {res.best_lcp} <= 0.4")
    w = torch.from_numpy(res.best_world_transform).to(dev)
    if w.shape != (4, 4) or not bool(torch.isfinite(w).all()):
        raise AssertionError("the best world transform is not a finite 4x4")
    mpos, _mn, spos, _sn, _sp, _gt = synthetic_arrays(480, 16384, 3)
    moved = torch.from_numpy(mpos).to(dev) @ w[:3, :3].T + w[:3, 3]
    nn = torch.cdist(moved, torch.from_numpy(spos).to(dev)).amin(dim=1)
    med = float(nn.median())
    print(f"median NN distance of the posed model to the scene {med:.6f} m "
          f"(limit {1.5 * cfg.distance_threshold})")
    if not med < 1.5 * cfg.distance_threshold:
        raise AssertionError("the posed model does not land on the scene")
    # which dense tiers this model can reach: a base goes to the top tier
    # only when a side's PPF bin union holds more than the tier below
    from model_matching_tpu_torch.congruent import tier_plan

    most, _bins = densest_bin_union(model.table)
    below = tier_plan(cfg.max_pairs_per_bin)[0][-1][0]
    print(f"the model's densest PPF bin union holds {most} pairs, "
          f"{'over' if most > below else 'at or under'} the {below}-pair tier: "
          f"{'some' if most > below else 'no'} base of this model can reach the "
          f"{cfg.max_pairs_per_bin}-pair top tier")

    # ---- 3, continued: the kernel on the main path's own launches
    _phase("kernel on the recorded launches")
    recorded = _recorded_gates_phase(torch, gates.calls, dense_gate,
                                     dense_gate_reference)
    gates.calls.clear()

    # ---- 5. the card against the CPU on a smaller input
    _phase("reference")
    model, scene, cfg = synthetic_setup(
        num_model=480, num_scene=4096, num_bases=16, max_pairs=8192,
        max_congruent=200, seed=3, device="cpu",
    )
    cpu = StocsEstimator(model, scene, cfg).run(verbose=False)
    before = _kernel_launches()["dense_gate_launches"]
    gpu = StocsEstimator(model.to(dev), scene.to(dev), cfg).run(verbose=False)
    pose_err = float(abs(cpu.best_world_transform - gpu.best_world_transform).max())
    # the scored pool: the ladder's leaders carry an exact LCP, the rest -1,
    # so the same leaders on both devices and their LCPs within 1e-5
    lcp_g = gpu.poses.lcp.cpu()
    lcp_err = float((lcp_g - cpu.poses.lcp).abs().max())
    same_leaders = torch.equal(lcp_g >= 0, cpu.poses.lcp >= 0)
    print(f"480/4096/16 bases/8192 pairs: best_index cpu {cpu.best_index} "
          f"cuda {gpu.best_index}; best_lcp cpu {cpu.best_lcp:.7f} cuda "
          f"{gpu.best_lcp:.7f}; pose max abs diff {pose_err:.3e}; "
          f"{int((cpu.poses.lcp >= 0).sum())} leaders, same on both: "
          f"{same_leaders}; poses.lcp max abs diff {lcp_err:.3e}; kernel "
          f"launches {_kernel_launches()['dense_gate_launches'] - before}")
    if _kernel_launches()["dense_gate_launches"] == before:
        raise AssertionError("the CUDA run of the comparison never launched the kernel")
    if (gpu.best_index != cpu.best_index or abs(gpu.best_lcp - cpu.best_lcp) > 1e-5
            or pose_err > 1e-4 or not same_leaders or lcp_err > 1e-5
            or not torch.equal(gpu.poses.valid.cpu(), cpu.poses.valid)):
        raise AssertionError("the CUDA run disagrees with the CPU run of the port")

    # ---- 6. the row-gather kernel against plain, on the card
    _phase("row_gather")
    gather_shapes, gather_err = _row_gather_phase(torch, dev, gathers)

    # ---- 7. the command-line path at full width
    _phase("files")
    files = _files_phase(torch, dev, dense_gate, row_gather)

    # ---- 8. the instance path at full width
    _phase("instance")
    inst = _instance_phase(torch, dev, dense_gate, dense_gate_reference, row_gather)

    # ---- 9. the chunked sweep with a checkpoint, clustering and the heatmap
    _phase("sweep")
    sweep = _sweep_phase(torch, dev, dense_gate, dense_gate_reference, row_gather)

    # ---- 10. three objects in one call, class and instance path
    _phase("multi")
    multi = _multi_phase(torch, dev, dense_gate, dense_gate_reference, row_gather)

    # ---- 11. stocs-batch, serve, eval and --profile
    _phase("commands")
    _commands_phase(torch, dev, multi)

    # ---- 12. sharded sweeps, two processes, multi over a mesh, native
    _phase("sharded")
    sharded = _sharded_phase(torch, dev, dense_gate, dense_gate_reference, row_gather,
                             multi, sweep)

    # ---- 14. the packed and linemod presets at full width
    _phase("presets")
    presets = _presets_phase(torch, dev, dense_gate, dense_gate_reference, row_gather)

    field = max((r for r in gather_shapes if r["what"] == "field rows"),
                key=lambda r: r["bytes"])
    print(json.dumps({"kernels": [{
        "name": "dense_gate",
        "route": "cuda",
        "source": "model_matching_tpu_torch/csrc/dense_gate.cu",
        "replaces": "model_matching_tpu/ops/pallas_congruent.py:180",
        "launches": files["dense_gate_launches"],
        "max_abs_err": max(max_err, recorded["max_abs_err"],
                           inst["gate_max_abs_err"], sweep["gate_max_abs_err"],
                           multi["gate_max_abs_err"], sharded["gate_max_abs_err"],
                           presets["gate_max_abs_err"],
                           presets["sweep"]["gate_max_abs_err"],
                           presets["block"]["gate_max_abs_err"],
                           presets["linemod"]["gate_max_abs_err"]),
        "ms": recorded["ms"],
        "plain_ms": recorded["plain_ms"],
        "bound_ms": recorded["bound_ms"],
        "bound_by": recorded["bound_by"],
        "library_ms": None,
        "timed_shape": recorded["shape"],
        "launches_synthetic_main": launches,
        "launches_instance": inst["dense_gate_launches"],
        "launches_sweep": sweep["dense_gate_launches"],
        "launches_multi": multi["class"]["dense_gate_launches"],
        "launches_multi_edge": multi["edge"]["dense_gate_launches"],
        "launches_sharded": sharded["dense_gate_launches"],
        "launches_sharded_instance": sharded["instance"]["dense_gate_launches"],
        "launches_packed": presets["dense_gate_launches"],
        "launches_packed_sweep": presets["sweep"]["dense_gate_launches"],
        "launches_packed_block8": presets["block"]["dense_gate_launches"],
        "launches_linemod": presets["linemod"]["dense_gate_launches"],
        "packed_launches_timed": presets["launch_rows"],
        "recorded_packed_sweep_launches": presets["sweep"]["gates"],
        "recorded_packed_block8_launches": presets["block"]["gates"],
        "recorded_linemod_launches": presets["linemod"]["gates"],
        "recorded_main_path_launch": recorded,
        "recorded_instance_launches": inst["gates"],
        "recorded_sweep_chunk_launches": sweep["gates"],
        "recorded_multi_launches": multi["gates"],
        "recorded_sharded_launches": sharded["gates"],
        "per_shape": per_shape,
    }, {
        "name": "row_gather",
        "route": "cuda",
        "source": "model_matching_tpu_torch/csrc/row_gather.cu",
        "replaces": "scripts/probe_vmem_gather.py:38",
        "launches": files["row_gather_launches"],
        "max_abs_err": max(gather_err, inst["gather_max_abs_err"],
                           sweep["gather_max_abs_err"], multi["gather_max_abs_err"],
                           sharded["gather_max_abs_err"], presets["gather_max_abs_err"],
                           presets["sweep"]["gather_max_abs_err"],
                           presets["block"]["gather_max_abs_err"],
                           presets["linemod"]["gather_max_abs_err"]),
        "ms": field["ms"],
        "plain_ms": field["plain_ms"],
        "bound_ms": field["bound_ms"],
        "bound_by": "bytes",
        "library_ms": field["library_ms"],
        "timed_shape": field["shape"],
        "launches_synthetic_main": gather_launches,
        "launches_instance": inst["row_gather_launches"],
        "launches_sweep": sweep["row_gather_launches"],
        "launches_multi": multi["class"]["row_gather_launches"],
        "launches_multi_edge": multi["edge"]["row_gather_launches"],
        "launches_sharded": sharded["row_gather_launches"],
        "launches_sharded_instance": sharded["instance"]["row_gather_launches"],
        "launches_packed": presets["row_gather_launches"],
        "launches_packed_sweep": presets["sweep"]["row_gather_launches"],
        "launches_packed_block8": presets["block"]["row_gather_launches"],
        "launches_linemod": presets["linemod"]["row_gather_launches"],
        "packed_gathers": presets["gathers"],
        "packed_sweep_gathers": presets["sweep"]["gathers"],
        "packed_block8_gathers": presets["block"]["gathers"],
        "per_shape": gather_shapes,
        "instance_gathers": inst["gathers"],
        "sweep_chunk_gathers": sweep["gathers"],
        "multi_gathers": multi["gathers"],
        "sharded_gathers": sharded["gathers"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


class _record_gathers:
    """Record every row gather that the scoring reads make (table and index
    tensors), by wrapping the name the two call sites use. The real wrapper
    still launches and counts."""

    def __init__(self, scene=None):
        from model_matching_tpu_torch.ops import densefield, gridhash

        self._mods = (densefield, gridhash)
        self._real = densefield.row_gather
        # without the scene (a command loads its own) a table is named by
        # its row width: field rows are 8 floats wide
        self._names = {} if scene is None else {
            scene.field.rows.data_ptr(): "field rows",
            scene.grid.payload.data_ptr(): "payload rows",
            scene.icp_grid.payload.data_ptr(): "ICP payload rows"}
        self.calls = []

        def recording(table, idx):
            name = self._names.get(table.data_ptr()) or (
                "field rows" if table.shape[1] == 8 else "payload rows")
            self.calls.append((name, table, idx.clone()))
            return self._real(table, idx)

        for m in self._mods:
            m.row_gather = recording

    def stop(self):
        for m in self._mods:
            m.row_gather = self._real


class _record_gates:
    """Record the arguments of every dense-gate launch that congruent
    extraction makes (and, with keep_outputs, its outputs), by wrapping the
    name its call site uses. The real wrapper still launches and counts."""

    def __init__(self, keep_outputs=False):
        from model_matching_tpu_torch import congruent

        self._mod = congruent
        self._real = congruent.dense_gate
        self.calls, self.outputs = [], []

        def recording(*args, **kw):
            self.calls.append((args, kw))
            out = self._real(*args, **kw)
            if keep_outputs:
                self.outputs.append(out)
            return out

        congruent.dense_gate = recording

    def stop(self):
        self._mod.dense_gate = self._real


_VIEW_OPS = frozenset(("view", "_unsafe_view", "expand", "select", "slice",
                       "unsqueeze", "squeeze", "reshape", "as_strided", "t",
                       "transpose", "permute", "alias", "detach", "unbind",
                       "lift_fresh", "scalar_tensor"))


def _kernel_launches(before=None):
    """K1 and K2 launches (the `k1.launches` and `k2.launches` counters of
    utils/trace.py), since the counts `before` if given."""
    from model_matching_tpu_torch.utils import trace

    now = {"dense_gate_launches": trace.total("k1.launches"),
           "row_gather_launches": trace.total("k2.launches")}
    return now if before is None else {k: v - before[k] for k, v in now.items()}


def _graph_counts(before=None):
    """The instance sampler's CUDA graphs captured and bases replayed (the
    `instance.graph_captures` and `instance.graph_replays` counters) and
    its kernel's launches (`base_rounds.launches`), since the counts
    `before` if given."""
    from model_matching_tpu_torch.utils import trace

    now = {k: trace.total(f"instance.graph_{k}") for k in ("captures", "replays")}
    now["launches"] = trace.total("base_rounds.launches")
    return now if before is None else {k: v - before[k] for k, v in now.items()}


def _check_graph_counts(counts, num_bases, captures, where):
    """A sequential sampler call on the card replays every base after the
    first from `captures` graphs, and launches the base-rounds kernel
    twice a base (eagerly or inside a replayed graph)."""
    want = {"captures": captures, "replays": num_bases - 1, "launches": 2 * num_bases}
    if counts != want:
        raise AssertionError(f"{where}: graph counters {counts}, expected {want}")


def _launches(torch, fn):
    """Torch operators that one call of `fn` dispatches, views and
    wrapped Python scalars aside: one device kernel each on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in _VIEW_OPS:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def _fmath_phase(torch, dev):
    """ops/fmath.py on the card against the CPU, bit for bit, over seeded
    inputs from the call sites' domains and the edge cases."""
    import numpy as np

    from model_matching_tpu_torch.ops import fmath
    from model_matching_tpu_torch.ops.fp import xla_sum0

    rng = np.random.default_rng(7)
    n = 1_000_003
    tiny = np.finfo(np.float32).tiny
    one = np.float32(1.0)
    base = np.array([
        0.0, 1.0, np.nextafter(one, np.float32(0)), np.nextafter(one, np.float32(2)),
        tiny, 1e-45, 1e-40, 5e-39, np.inf, np.nan, 0.5, 2.0, 2.4375, 0.4375,
        2.0 ** -29, 2.0 ** 25, 1e30, 3.4e38, np.pi, np.pi / 2, 119.9, 120.0,
        1e5, 1e10], np.float32)
    edges = np.concatenate([base, -base])
    unit = rng.uniform(-1, 1, n)
    angles = np.concatenate([rng.uniform(0, 2 * np.pi, n // 2),
                             rng.normal(0, 0.05, n // 4),
                             rng.uniform(-1e4, 1e4, n - n // 2 - n // 4)])
    logs = np.concatenate([np.maximum(rng.random(n // 2), tiny),
                           -np.log(np.maximum(rng.random(n // 4), tiny)),
                           10.0 ** rng.uniform(-30, 0, n - n // 2 - n // 4)])
    wide = rng.normal(0, 1, n) * 10.0 ** rng.uniform(-20, 20, n)
    cases = [("acos", fmath.acos, torch.acos, unit), ("asin", fmath.asin, torch.asin, unit),
             ("sin", fmath.sin, torch.sin, angles), ("cos", fmath.cos, torch.cos, angles),
             ("log", fmath.log, torch.log, logs), ("log2", fmath.log2, torch.log2, logs),
             ("atan", fmath.atan, torch.atan, wide)]

    def differ(a, b):
        a, b = a.cpu(), b.cpu()
        same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
        return int((~same).sum())

    total = 0
    for name, f, torch_f, dom in cases:
        x = torch.from_numpy(np.concatenate([dom, edges]).astype(np.float32))
        xg = x.to(dev)
        bad = differ(f(xg), f(x))
        total += x.numel()
        print(f"fmath.{name}: {x.numel()} inputs, {bad} differ card against CPU; "
              f"call {_time_ms(torch, lambda: f(xg), runs=3):.4f} ms, "
              f"{_launches(torch, lambda: f(xg))} ops (torch.{torch_f.__name__} "
              f"{_time_ms(torch, lambda: torch_f(xg), runs=3):.4f} ms, "
              f"{_launches(torch, lambda: torch_f(xg))} ops)")
        if bad:
            raise AssertionError(f"fmath.{name} gives other bits on the card")
    ey, ex = (torch.from_numpy(v.ravel()) for v in np.meshgrid(edges, edges))
    y = torch.cat([torch.from_numpy(np.concatenate([
        rng.random(n // 2), rng.normal(0, 1, n - n // 2)]).astype(np.float32)), ey])
    x = torch.cat([torch.from_numpy(np.concatenate([
        rng.uniform(-1, 1, n // 2), rng.normal(0, 1, n - n // 2)]).astype(np.float32)), ex])
    yg, xg = y.to(dev), x.to(dev)
    bad = differ(fmath.atan2(yg, xg), fmath.atan2(y, x))
    total += y.numel()
    print(f"fmath.atan2: {y.numel()} pairs, {bad} differ card against CPU; call "
          f"{_time_ms(torch, lambda: fmath.atan2(yg, xg), runs=3):.4f} ms, "
          f"{_launches(torch, lambda: fmath.atan2(yg, xg))} ops (torch.atan2 "
          f"{_time_ms(torch, lambda: torch.atan2(yg, xg), runs=3):.4f} ms, "
          f"{_launches(torch, lambda: torch.atan2(yg, xg))} ops)")
    if bad:
        raise AssertionError("fmath.atan2 gives other bits on the card")
    # pow: the block decay's bases in (0, 1] with integer exponents 0..256,
    # random finite pairs, and every pair of edge values
    pb = np.concatenate([1.0 - rng.random(n), rng.normal(0, 1, n) * 10.0 ** rng.uniform(
        -30, 30, n), ey.numpy()]).astype(np.float32)
    pe = np.concatenate([rng.integers(0, 257, n), np.round(rng.normal(0, 30, n)),
                         ex.numpy()]).astype(np.float32)
    x, y = torch.from_numpy(pb), torch.from_numpy(pe)
    xg, yg = x.to(dev), y.to(dev)
    bad = differ(fmath.pow(xg, yg), fmath.pow(x, y))
    total += x.numel()
    print(f"fmath.pow: {x.numel()} pairs, {bad} differ card against CPU; call "
          f"{_time_ms(torch, lambda: fmath.pow(xg, yg), runs=3):.4f} ms, "
          f"{_launches(torch, lambda: fmath.pow(xg, yg))} ops (torch.pow "
          f"{_time_ms(torch, lambda: torch.pow(xg, yg), runs=3):.4f} ms, "
          f"{_launches(torch, lambda: torch.pow(xg, yg))} ops)")
    if bad:
        raise AssertionError("fmath.pow gives other bits on the card")
    for rows in (16384, 19200, 307200):
        p = torch.from_numpy(rng.normal(0.5, 0.2, (rows, 3)).astype(np.float32))
        if not torch.equal(xla_sum0(p.to(dev)).cpu(), xla_sum0(p)):
            raise AssertionError(f"xla_sum0 over {rows} rows gives other bits on the card")
    print(f"fmath: {total} inputs in all, card == CPU bit for bit; xla_sum0 "
          f"equal over 16384, 19200 and 307200 rows")


def _gate_bound(torch, dense_gate_reference, args, kw, ms):
    """The least time the card could take for one dense-gate call, from its
    inputs alone, whatever implements the gate. Bytes: each input that the
    call's modes need read once (of a side's 8 feature rows the 3 direction
    rows when the cone test is on, the 3 position rows and the squared norm
    when the distance test is on, never the unused last row) and each
    output written once. Operations, two counts: the bucketed one
    (one bucket operation per P row and Q column, plus the cone test, key
    packing and stripe max, 14 operations, for each pair of equal cells in
    an evaluated tile: the pairs whose float test the result depends on),
    and the former one (a cell compare for every (p, q) pair of an
    evaluated tile, plus the same 14; a tile outside the live mask or past
    the valid lanes is not evaluated). The same-cell pairs are counted by
    the plain version with both float tests off."""
    from model_matching_tpu_torch.ops.dense_gate import P_TILE, _tile_ok

    pc, qc = args[2], args[3]
    b, p = pc.shape
    q = qc.shape[1]
    n_pt, q_tile = -(-p // P_TILE), kw["q_tile"]
    ok = _tile_ok(kw["p_count"], kw["q_count"], kw.get("live"), n_pt, q // q_tile, q_tile)
    rows = torch.full((n_pt,), P_TILE, dtype=torch.int64, device=pc.device)
    rows[-1] = p - P_TILE * (n_pt - 1)
    evaluated = int((ok.sum((0, 2)) * rows).sum()) * q_tile
    tensors = list(args[2:7]) + [kw["p_count"], kw["q_count"]]
    if kw.get("live") is not None:
        tensors.append(kw["live"])
    feat_rows = (3 if kw.get("check_cos", True) else 0) + (0 if kw["skip_dist"] else 4)
    nbytes = (sum(t.numel() * t.element_size() for t in tensors)
              + feat_rows * b * (p + q) * 4
              + b * p * kw.get("n_sub", 16) * 4 + b * p * 4)
    off = dict(kw, skip_dist=True, check_cos=False)
    same = int(dense_gate_reference(*args, **off)[1].sum(dtype=torch.int64))
    bytes_ms = nbytes / _HBM_BYTES_PER_S * 1e3
    ops_ms = (b * (p + q) + 14 * same) / _FP32_OPS_PER_S * 1e3
    former_ms = (evaluated + 14 * same) / _FP32_OPS_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    out = {"bytes": nbytes, "same_cell_pairs": same,
           "same_cell_share": same / (b * p * q), "evaluated_pairs": evaluated,
           "bound_ms": bound, "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
           "share_of_bound": bound / ms,
           "bound_ms_former_count": max(bytes_ms, former_ms),
           "share_of_former_bound": max(bytes_ms, former_ms) / ms}
    if out["share_of_bound"] > 1 or out["share_of_former_bound"] > 1:
        raise AssertionError(f"the dense gate beats its bound: {out}: the bound "
                             f"is not a least time")
    return out


def _bound_text(row):
    return (f"same-cell pairs {row['same_cell_pairs']} "
            f"({row['same_cell_share'] * 100:.4f}% of P x Q); bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
            f"({row['share_of_bound'] * 100:.1f}% reached), by the former count "
            f"{row['bound_ms_former_count']:.4f} ms "
            f"({row['share_of_former_bound'] * 100:.1f}%)")


def _recorded_gates_phase(torch, calls, dense_gate, dense_gate_reference):
    """Kernel == plain on every dense-gate launch the main path's warm-up
    run made; the largest one (bases x P x Q) is timed."""
    if not calls:
        raise AssertionError("the main path's warm-up run launched no dense gate")
    shape_of = lambda a: (a[2].shape[0], a[2].shape[1], a[3].shape[1])
    max_err = 0
    for args, kw in calls:
        b, p, q = shape_of(args)
        err, n_match = _gate_equal(
            torch, dense_gate, dense_gate_reference, args, kw,
            f"a recorded launch, {b} bases P={p} Q={q}")
        max_err = max(max_err, err)
        print(f"recorded launch: {b} bases, P={p}, Q={q}, q_tile={kw['q_tile']}, "
              f"n_sub={kw['n_sub']}, skip_dist={kw['skip_dist']}, live="
              f"{kw['live'] is not None}: equal; {n_match} matches")
    args, kw = max(calls, key=lambda c: shape_of(c[0])[0] * shape_of(c[0])[1]
                   * shape_of(c[0])[2])
    b, p, q = shape_of(args)
    ms = _device_ms(torch, lambda: dense_gate(*args, **kw))
    call_ms = _time_ms(torch, lambda: dense_gate(*args, **kw))
    plain_ms = _time_ms(torch, lambda: dense_gate_reference(*args, **kw), runs=3)
    pc, qc = args[2], args[3]
    cells = int(torch.unique(torch.cat([pc[pc >= 0], qc[qc >= 0]])).numel())
    row = {"shape": f"{b} bases, P={p}, Q={q}, q_tile={kw['q_tile']}",
           "bases": b, "p": p, "q": q, "q_tile": kw["q_tile"],
           "valid_p_lanes": int(kw["p_count"].sum()),
           "valid_q_lanes": int(kw["q_count"].sum()),
           "distinct_cells": cells, "max_abs_err": max_err, "ms": ms,
           "call_ms": call_ms, "plain_ms": plain_ms}
    row.update(_gate_bound(torch, dense_gate_reference, args, kw, ms))
    print(f"largest recorded launch ({row['shape']}; {row['valid_p_lanes']} / "
          f"{row['valid_q_lanes']} valid P / Q lanes; {cells} distinct cells): "
          f"kernel {ms:.4f} ms on the device ({call_ms:.4f} ms a call back to "
          f"back), plain {plain_ms:.4f} ms; {_bound_text(row)}")
    return row


def _row_gather_phase(torch, dev, gathers):
    gen = torch.Generator().manual_seed(5)
    cases = []
    for rows, n_idx in ((8, 8), (64, 64), (1024, 256), (4096, 512)):
        tab = torch.randn(rows, 128, generator=gen).to(dev)
        idx = torch.randint(0, rows, (n_idx,), generator=gen, dtype=torch.int32).to(dev)
        cases.append((f"probe [{rows}, 128] x {n_idx}", tab, idx))
    for what in ("field rows", "payload rows"):
        if not any(name == what for name, _tab, _idx in gathers.calls):
            raise AssertionError(f"the main path made no {what} gather")
    for what, tab, idx in gathers.calls:
        cases.append((f"{what} {list(tab.shape)} x {list(idx.shape)}", tab, idx))
    flat = torch.randn(1 + 5000 * 8, generator=gen).to(dev)
    cases.append(("misaligned [5000, 8] x 4096", flat[1:].view(5000, 8),
                  torch.randint(0, 5000, (4096,), generator=gen).to(dev)))
    return _check_gathers(torch, cases)


def _check_gathers(torch, cases, time_repeats=True):
    """row_gather == its plain version bit for bit on every (name, table,
    index) case, int32 and int64 indices; each case is timed warm beside
    the plain version and torch.index_select (with time_repeats=False only
    the first case of each name and shape). Returns (rows, max_abs_err)."""
    from model_matching_tpu_torch.ops.row_gather import row_gather, row_gather_reference

    out, max_err, seen = [], 0.0, set()
    for name, tab, idx in cases:
        for dtype in (torch.int32, torch.int64):
            ix = idx.to(dtype)
            got = row_gather(tab, ix)
            ref = row_gather_reference(tab, ix)
            torch.cuda.synchronize()
            max_err = max(max_err, float((got - ref).abs().max()))
            if not torch.equal(got, ref):
                raise AssertionError(f"row_gather differs from the plain version: "
                                     f"{name} {dtype}")
        if not time_repeats and name in seen:
            continue
        seen.add(name)
        ix = idx.reshape(-1)
        ms = _time_ms(torch, lambda: row_gather(tab, ix))
        plain_ms = _time_ms(torch, lambda: row_gather_reference(tab, ix))
        lib_ms = _time_ms(torch, lambda: torch.index_select(tab, 0, ix))
        dev_ms = _device_ms(torch, lambda: row_gather(tab, ix))
        lib_dev_ms = _device_ms(torch, lambda: torch.index_select(tab, 0, ix))
        c = tab.shape[1]
        moved = (int(torch.unique(ix).numel()) * c * 4 + ix.numel() * ix.element_size()
                 + ix.numel() * c * 4)
        bound_ms = moved / _HBM_BYTES_PER_S * 1e3
        row = {"what": name.split(" [")[0], "shape": name, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms, "bytes": moved,
               "device_ms": dev_ms, "library_device_ms": lib_dev_ms}
        out.append(row)
        print(f"row_gather {name}: equal (int32, int64); a call back to back: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, index_select {lib_ms:.4f} ms; on "
              f"the device: kernel {dev_ms:.4f} ms, index_select {lib_dev_ms:.4f} ms; "
              f"bound {bound_ms:.4f} ms ({moved} bytes)")
    return out, max_err


def _ingest_breakdown(torch, dev, paths, cfg):
    """Wall time of load_scene's stages on the card, warm: PNG reads, the
    device pipeline with the read of its point count, and the builds of
    the two grids and the dense field on the card."""
    import numpy as np

    from model_matching_tpu_torch import scene as sc
    from model_matching_tpu_torch.estimator import _to_host
    from model_matching_tpu_torch.ops.densefield import build_dense_field
    from model_matching_tpu_torch.ops.gridhash import build_neighbor_grid

    t = {}
    t0 = time.perf_counter()
    rgb, depth, probs, edge, _has_edge = sc._read_images(paths[0], paths[1], [paths[2]], None)
    t["read_png"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = sc._scene_pipeline(torch.from_numpy(rgb).to(dev),
                             torch.from_numpy(depth.astype(np.int32)).to(dev),
                             torch.from_numpy(probs.astype(np.int32)).to(dev),
                             torch.from_numpy(edge).to(dev), cfg)
    (n,) = (int(v) for v in _to_host(out["count"]))
    t["device_pipeline"] = time.perf_counter() - t0
    pos, nrm, prob = out["pos"][:n], out["normal"][:n], out["class_prob"][0, :n]
    for name, build in (
            ("grid", lambda: build_neighbor_grid(pos, cfg.distance_threshold,
                                                 normal=nrm, prob=prob)),
            ("field", lambda: build_dense_field(pos, nrm, cfg.distance_threshold, prob=prob)),
            ("icp_grid", lambda: build_neighbor_grid(pos, cfg.icp_max_corr_dist))):
        t0 = time.perf_counter()
        build()
        torch.cuda.synchronize()
        t[name] = time.perf_counter() - t0
    print(f"load_scene stages on the card, warm ({_gpu_name_and_limit()}): "
          + json.dumps({k: round(v * 1e3, 3) for k, v in t.items()}) + " ms")


def _warm_estimator(torch, dev, root, obj, scene, cfg):
    """Per-phase wall times of warm stocs-single runs on the ingested
    scene (the command's own run above is the process's first)."""
    from model_matching_tpu_torch.estimator import StocsEstimator
    from model_matching_tpu_torch.model import load_model_pack

    mdir = os.path.join(root, "models", obj)
    t0 = time.perf_counter()
    model = load_model_pack(os.path.join(mdir, "model_search.ply"),
                            os.path.join(mdir, "ppf_table.npz"),
                            cfg.max_model_points, device=dev)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    est = StocsEstimator(model, scene, cfg)
    est.run(verbose=False)
    walls, runs = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        runs.append(est.run(verbose=False))
        walls.append(time.perf_counter() - t0)
    order = sorted(range(5), key=walls.__getitem__)
    med = runs[order[2]]
    print(f"files path, warm ({_gpu_name_and_limit()}): load_model_pack "
          f"{t_model * 1e3:.3f} ms; estimator run median {walls[order[2]] * 1e3:.3f} ms "
          f"(min {walls[order[0]] * 1e3:.3f}, max {walls[order[-1]] * 1e3:.3f}) over 5; "
          f"median run's phases_ms "
          + json.dumps({k: round(v * 1e3, 3) for k, v in med.timings.items()})
          + f"; best_lcp {med.best_lcp:.6f}, {med.num_bases} bases, "
          f"{med.num_hypotheses} hypotheses")


def _files_phase(torch, dev, dense_gate, row_gather):
    import numpy as np

    from model_matching_tpu_torch import cli
    from model_matching_tpu_torch.config import get_preset
    from model_matching_tpu_torch.io import ply
    from model_matching_tpu_torch.scene import load_scene
    from model_matching_tpu_torch.synthetic import write_synthetic_scene

    root = os.path.join(_ROOT, "build", "chip_smoke_files")
    shutil.rmtree(root, ignore_errors=True)
    obj = "synthetic_shell"
    scene_dir, cfg, _gt = write_synthetic_scene(root, obj)
    if cfg != get_preset("ycb").match:
        raise AssertionError("the scene was not written at the ycb preset's camera")
    k_before = _kernel_launches()
    t0 = time.perf_counter()
    if cli.main(["model-preprocess", obj, "--repo-path", root]) != 0:
        raise AssertionError("model-preprocess failed")
    t_pre = time.perf_counter() - t0
    t0 = time.perf_counter()
    if cli.main(["stocs-single", scene_dir, obj, "--repo-path", root]) != 0:
        raise AssertionError("stocs-single failed")
    t_single = time.perf_counter() - t0
    counts = _kernel_launches(k_before)
    print(f"files: model-preprocess {t_pre:.3f} s, stocs-single {t_single:.3f} s "
          f"(first runs, kernels built); launches {json.dumps(counts)}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"the command-line path missed a kernel: {counts}")

    for name in ("sampled_scene.ply", "best_pose.ply", "scene.ply"):
        if not os.path.exists(os.path.join(scene_dir, "dbg", name)):
            raise AssertionError(f"dbg/{name} was not written")

    paths = [os.path.join(scene_dir, n) for n in
             ("rgb.png", "depth.png", f"probability_maps/{obj}.png")]
    ingest = []
    for _ in range(3):
        t0 = time.perf_counter()
        gpu = load_scene(*paths, None, cfg, device=dev)
        torch.cuda.synchronize()
        ingest.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    cpu = load_scene(*paths, None, cfg, device="cpu")
    t_cpu = time.perf_counter() - t0
    n_s = int(gpu.count())
    mpos = ply.read_ply_cloud(os.path.join(root, "models", obj, "model_search.ply"))[0]
    print(f"|M| = {mpos.shape[0]}, |S| = {n_s}; load_scene on the card {ingest[0]:.3f} s "
          f"first, {min(ingest[1:]):.3f} s warm; on the CPU {t_cpu:.3f} s")
    if n_s <= 3000:
        raise AssertionError(f"|S| = {n_s}: the scene is too small")
    for f in ("valid", "pos", "normal", "class_prob"):
        if not torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)):
            raise AssertionError(f"load_scene on the card differs from the CPU in {f}")
    _ingest_breakdown(torch, dev, paths, cfg)
    _warm_estimator(torch, dev, root, obj, gpu, cfg)
    _pose_file_on_scene(torch, dev, np,
                        os.path.join(scene_dir, f"best_pose_candidate_{obj}.txt"),
                        os.path.join(root, "models", obj, "model_search.ply"), gpu, cfg)
    return counts

class _log_events(logging.Handler):
    """Collect what the port logs while a command runs: its one-line JSON
    events (stocs_run, stocs_sweep with their stats) and its warnings."""

    def __init__(self):
        from model_matching_tpu_torch.utils.log import get_logger

        super().__init__()
        self.events, self.warnings = [], []
        self._logger = get_logger()
        self._logger.addHandler(self)

    def emit(self, record):
        msg = record.getMessage()
        if record.levelno >= logging.WARNING:
            self.warnings.append(msg)
        elif msg.startswith("{"):
            self.events.append(json.loads(msg))

    def last(self, event):
        found = [e for e in self.events if e.get("event") == event]
        if not found:
            raise AssertionError(f"no {event} event was logged")
        return found[-1]

    def stop(self):
        self._logger.removeHandler(self)


def _slice_bases(args, kw, keep):
    """The dense-gate arguments of the bases `keep` of a recorded launch
    (the gate is independent per base)."""
    pick = lambda t: t[keep].contiguous()
    out_kw = dict(kw, p_count=pick(kw["p_count"]), q_count=pick(kw["q_count"]),
                  live=None if kw.get("live") is None else pick(kw["live"]))
    return tuple(pick(a) for a in args[:7]) + tuple(args[7:]), out_kw


def _check_recorded_gates(torch, calls, dense_gate, dense_gate_reference, where):
    """Kernel == plain bit for bit on every recorded dense-gate launch of a
    path: all bases of a launch of up to three, else its first two and its
    last (printed). The largest launch (bases x P x Q) is timed whole on
    the kernel; the plain version is timed on the checked bases."""
    if not calls:
        raise AssertionError(f"{where}: no dense-gate launch was recorded")
    shape_of = lambda a: (a[2].shape[0], a[2].shape[1], a[3].shape[1])
    rows, max_err = [], 0
    for args, kw in calls:
        b, p, q = shape_of(args)
        keep = list(range(b)) if b <= 3 else [0, 1, b - 1]
        s_args, s_kw = _slice_bases(args, kw, keep)
        err, n_match = _gate_equal(
            torch, dense_gate, dense_gate_reference, s_args, s_kw,
            f"{where}: a recorded launch, {b} bases P={p} Q={q}, bases {keep}")
        max_err = max(max_err, err)
        rows.append({"bases": b, "p": p, "q": q, "q_tile": kw["q_tile"],
                     "n_sub": kw["n_sub"], "checked_bases": keep, "matches": n_match})
        print(f"{where} recorded launch: {b} bases, P={p}, Q={q}, q_tile={kw['q_tile']}, "
              f"n_sub={kw['n_sub']}, skip_dist={kw['skip_dist']}, live="
              f"{kw['live'] is not None}: bases {keep} equal; {n_match} matches there")
    big = max(range(len(calls)), key=lambda i: rows[i]["bases"] * rows[i]["p"] * rows[i]["q"])
    args, kw = calls[big]
    ms = _device_ms(torch, lambda: dense_gate(*args, **kw), runs=5)
    s_args, s_kw = _slice_bases(args, kw, rows[big]["checked_bases"])
    plain_ms = _time_ms(torch, lambda: dense_gate_reference(*s_args, **s_kw), runs=2)
    n_checked = len(rows[big]["checked_bases"])
    out_elems = rows[big]["bases"] * rows[big]["p"] * kw["n_sub"]
    rows[big].update(ms=ms, plain_ms_checked_bases=plain_ms,
                     plain_ms_per_base=plain_ms / n_checked, output_elements=out_elems)
    print(f"{where} largest recorded launch ({rows[big]['bases']} bases, P={rows[big]['p']}, "
          f"Q={rows[big]['q']}; {out_elems} stripe maxima): kernel {ms:.4f} ms on the "
          f"device ({ms / rows[big]['bases']:.4f} ms a base); plain {plain_ms:.4f} ms for "
          f"{n_checked} bases")
    return {"launches": rows, "largest": rows[big], "max_abs_err": max_err}


def _recorded_gather_cases(calls):
    return [(f"{what} {list(tab.shape)} x {list(idx.shape)}", tab, idx)
            for what, tab, idx in calls]


def _pose_file_on_scene(torch, dev, np, path, model_ply, scene, cfg, own=None):
    """The 3x4 pose file is finite and orthonormal and its posed model lies
    on the ingested scene (or on its points where the mask `own` holds);
    returns the median NN distance."""
    from model_matching_tpu_torch.io import ply

    pose = np.loadtxt(path)
    if pose.shape != (12,) or not np.isfinite(pose).all():
        raise AssertionError(f"{path} is not 12 finite numbers")
    w = pose.reshape(3, 4)
    if not np.allclose(w[:, :3] @ w[:, :3].T, np.eye(3), atol=1e-4):
        raise AssertionError(f"{path}: the pose's rotation is not orthonormal")
    mpos = ply.read_ply_cloud(model_ply)[0]
    wt = torch.from_numpy(w.astype(np.float32)).to(dev)
    moved = torch.from_numpy(mpos).to(dev) @ wt[:, :3].T + wt[:, 3]
    keep = scene.valid if own is None else scene.valid & own
    scene_pts = scene.pos[keep] + scene.centroid
    med = float(torch.cdist(moved, scene_pts).amin(dim=1).median())
    print(f"{path}: posed model median NN distance to the ingested scene"
          f"{'' if own is None else ' (its own points)'} {med:.6f} m "
          f"(limit {1.5 * cfg.distance_threshold})")
    if not med < 1.5 * cfg.distance_threshold:
        raise AssertionError(f"{path}: the posed model does not land on the scene")
    return med


def _instance_phase(torch, dev, dense_gate, dense_gate_reference, row_gather):
    import dataclasses

    import numpy as np

    from model_matching_tpu_torch import cli, rng
    from model_matching_tpu_torch import estimator as est_mod
    from model_matching_tpu_torch.config import get_preset
    from model_matching_tpu_torch.model import load_model_pack
    from model_matching_tpu_torch.scene import load_scene
    from model_matching_tpu_torch.synthetic import write_synthetic_scene

    root = os.path.join(_ROOT, "build", "chip_smoke_instance")
    shutil.rmtree(root, ignore_errors=True)
    obj = "synthetic_shell"
    scene_dir, cfg, _gt = write_synthetic_scene(root, obj, edge=True)
    if cfg != get_preset("ycb").match:
        raise AssertionError("the scene was not written at the ycb preset's camera")
    if cli.main(["model-preprocess", obj, "--repo-path", root]) != 0:
        raise AssertionError("model-preprocess failed")
    log = _log_events()
    gathers, gates = _record_gathers(), _record_gates()
    k_before, g_before = _kernel_launches(), _graph_counts()
    t0 = time.perf_counter()
    rc = cli.main(["stocs-single", scene_dir, obj, "--repo-path", root,
                   "--cluster", "--heatmap"])
    t_single = time.perf_counter() - t0
    counts, graphs = _kernel_launches(k_before), _graph_counts(g_before)
    gathers.stop()
    gates.stop()
    log.stop()
    if rc != 0:
        raise AssertionError("stocs-single failed on the edge-mapped scene")
    run = log.last("stocs_run")
    print(f"instance: stocs-single {t_single:.3f} s (first run on this scene); launches "
          f"{json.dumps(counts)}; phases_ms {json.dumps(run['timings_ms'])}; best_lcp "
          f"{run['best_lcp']:.6f}, {run['bases']} bases, {run['hypotheses']} hypotheses; "
          f"unconverged flood fills {run['unconverged_fills']}; sample_bases "
          f"{run['timings_ms']['sample_bases'] / 1e3:.4f} s, graphs {json.dumps(graphs)}")
    _check_graph_counts(graphs, cfg.number_of_bases, 3, "instance stocs-single")
    for w in log.warnings:
        print(f"warning logged: {w}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"the instance path missed a kernel: {counts}")
    dbg = os.path.join(scene_dir, "dbg")
    n_masks = len([f for f in os.listdir(dbg) if f.startswith("seg_mask_")])
    for name in ("sampled_scene.ply", "best_pose.ply", "scene.ply",
                 "probability_heatmap.png", f"overlay_{obj}.png"):
        if not os.path.exists(os.path.join(dbg, name)):
            raise AssertionError(f"dbg/{name} was not written")
    clusters = np.loadtxt(os.path.join(scene_dir, f"clustered_poses_{obj}.txt"), ndmin=2)
    if n_masks < 1 or clusters.shape[0] < 1 or clusters.shape[1] != 13:
        raise AssertionError("segment masks or clustered poses are missing")
    print(f"{n_masks} segment masks, {clusters.shape[0]} clusters (best LCP "
          f"{clusters[0, 12]:.6f}), heatmap and overlay written")

    maps = os.path.join(scene_dir, "probability_maps")
    paths = [os.path.join(scene_dir, "rgb.png"), os.path.join(scene_dir, "depth.png"),
             os.path.join(maps, f"{obj}.png"), os.path.join(maps, "edge.png")]
    scene = load_scene(*paths, cfg, device=dev)
    if not scene.has_edge or bool(scene.edge_free.all()):
        raise AssertionError("the scene did not load its edge map")
    mdir = os.path.join(root, "models", obj)
    model_ply = os.path.join(mdir, "model_search.ply")
    model = load_model_pack(model_ply, os.path.join(mdir, "ppf_table.npz"),
                            cfg.max_model_points, device=dev)
    _pose_file_on_scene(torch, dev, np, os.path.join(
        scene_dir, f"best_pose_candidate_{obj}.txt"), model_ply, scene, cfg)

    # the sampler on the ingested scene: its outputs, timed warm
    k_sample = rng.split(rng.PRNGKey(cfg.seed))[0]
    from model_matching_tpu_torch import instance

    def sample():
        return instance.sample_instance_bases_stepwise(
            k_sample, model.table, scene.pos, scene.normal, scene.class_prob,
            scene.edge_prob, scene.pixel, scene.valid, scene.edge_free,
            num_bases=cfg.number_of_bases, dispersion=cfg.sample_dispersion,
            tr_disc=cfg.ppf_tr_discretization, rot_disc=cfg.ppf_rot_discretization,
            plane_threshold=cfg.plane_threshold,
            min_distance_base=cfg.min_distance_base,
            internal_angle_threshold=cfg.internal_angle_threshold,
            flood_max_iters=cfg.flood_fill_max_iters, block=cfg.instance_scan_block,
            flood_sweeps=cfg.flood_fill_sweeps or None)

    # four runs; the first warms up, the median of the other three stays
    # (single runs differ by the host's noise)
    walls = []
    for _ in range(4):
        g_before = _graph_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = sample()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        _check_graph_counts(_graph_counts(g_before), cfg.number_of_bases, 3, "instance")
    n_b = cfg.number_of_bases
    ms_per_base = sorted(walls[1:])[1] / n_b * 1e3
    masks = s.seg_masks
    distinct = int(torch.unique(masks[1:].flatten(1).to(torch.uint8), dim=0).shape[0])
    print(f"instance sampling, {n_b} bases, warm, median of 3 ({_gpu_name_and_limit()}): "
          f"{ms_per_base:.4f} ms a base "
          f"{[round(t / n_b * 1e3, 4) for t in walls[1:]]}; "
          f"{int(s.valid.sum())} valid bases, {distinct} distinct segments, "
          f"{int((~s.fill_converged).sum())} unconverged fills; each call replayed "
          f"{n_b - 1} bases from the 3 graphs it captured")
    live = scene.valid
    if bool((s.class_prob[live] > scene.class_prob[live]).any()):
        raise AssertionError("the decayed prior rose somewhere")
    if not bool((s.class_prob[live] < scene.class_prob[live]).any()):
        raise AssertionError("the prior was not decayed")
    pts = s.indices[s.valid].long()                          # [V, 4]
    if pts.shape[0] < 1:
        raise AssertionError("the instance sampler drew no valid base")
    base_of = torch.nonzero(s.valid)[:, 0] + 1
    pix = scene.pixel[pts].long()                            # [V, 4, 2]
    inside = masks[base_of[:, None], pix[..., 0], pix[..., 1]]
    if not bool(inside.all()):
        raise AssertionError("a valid base has a point outside its own segment")
    if bool((scene.edge_prob[pts] == 1.0).any()) or not bool(
            scene.edge_free[pix[..., 0], pix[..., 1]].all()):
        raise AssertionError("a valid base has a point on an edge pixel")
    print(f"decayed: {int((s.class_prob[live] < scene.class_prob[live]).sum())} of "
          f"{int(live.sum())} points below their ingested probability, none above; every "
          f"valid base inside its own segment, none on an edge pixel "
          f"({int((scene.edge_prob[live] == 1.0).sum())} scene points lie on one)")

    gate_rows = _check_recorded_gates(torch, gates.calls, dense_gate,
                                      dense_gate_reference, "instance")
    gather_rows, gather_err = _check_gathers(
        torch, _recorded_gather_cases(gathers.calls), time_repeats=False)
    gates.calls.clear()
    gathers.calls.clear()

    # the card against the CPU at a reduced size
    small_root = os.path.join(root, "small")
    small_dir, small_cfg, _gt = write_synthetic_scene(small_root, obj, scale=0.25, edge=True)
    small_cfg = dataclasses.replace(
        small_cfg, number_of_bases=16, voxel_size=0.01, max_scene_points=4096,
        max_pairs_per_bin=2048, maximum_congruent_sets=64)
    maps = os.path.join(small_dir, "probability_maps")
    paths = [os.path.join(small_dir, "rgb.png"), os.path.join(small_dir, "depth.png"),
             os.path.join(maps, f"{obj}.png"), os.path.join(maps, "edge.png")]
    sc_cpu = load_scene(*paths, small_cfg, device="cpu")
    sc_gpu = load_scene(*paths, small_cfg, device=dev)
    m_cpu = model.to("cpu")
    res, ests = {}, {}
    for name, m, sc in (("cpu", m_cpu, sc_cpu), ("cuda", model, sc_gpu)):
        inst = est_mod._phase_sample_instance(
            rng.split(rng.PRNGKey(0))[0], m.table, sc, sc.class_prob, small_cfg, 16)
        ests[name] = est_mod.StocsEstimator(m, sc, small_cfg)
        res[name] = (inst, ests[name].run(verbose=False))
    (i_c, r_c), (i_g, r_g) = res["cpu"], res["cuda"]
    for f in i_c._fields:
        if not torch.equal(getattr(i_c, f), getattr(i_g, f).cpu()):
            raise AssertionError(f"instance: the sampler's {f} differs card against CPU")
    same = (torch.equal(ests["cpu"].seg_masks, ests["cuda"].seg_masks.cpu())
            and torch.equal(ests["cpu"].class_prob, ests["cuda"].class_prob.cpu()))
    print(f"160x120, 16 bases, |S| = {int(sc_cpu.count())}: card against CPU: sampled "
          f"bases, masks and decayed prior equal: {same}; best_index cpu {r_c.best_index} "
          f"cuda {r_g.best_index}; best_lcp cpu {r_c.best_lcp:.7f} cuda {r_g.best_lcp:.7f}; "
          f"{r_c.num_bases} bases, {r_c.num_hypotheses} hypotheses")
    if (not same or r_c.best_index != r_g.best_index or r_c.best_index < 0
            or abs(r_c.best_lcp - r_g.best_lcp) > 1e-5):
        raise AssertionError("the instance path on the card disagrees with the CPU")
    return dict(counts, gates=gate_rows, gate_max_abs_err=gate_rows["max_abs_err"],
                gathers=gather_rows, gather_max_abs_err=gather_err,
                sampling_ms_per_base=ms_per_base,
                phases_ms=run["timings_ms"], graphs=graphs)


def _sweep_phase(torch, dev, dense_gate, dense_gate_reference, row_gather):
    import numpy as np

    from model_matching_tpu_torch import cli, estimator, sampling
    from model_matching_tpu_torch.config import get_preset
    from model_matching_tpu_torch.scene import load_scene

    root = os.path.join(_ROOT, "build", "chip_smoke_files")    # phase 7's files
    obj = "synthetic_shell"
    scene_dir = os.path.join(root, "scene")
    cfg = get_preset("ycb").match
    base = ["stocs-single", scene_dir, obj, "--repo-path", root, "--sweep", "4096",
            "--sweep-chunk", "2048", "--cluster", "--heatmap"]
    pose_file = os.path.join(scene_dir, f"best_pose_candidate_{obj}.txt")
    ignored = [os.path.join(scene_dir, f"clustered_poses_{obj}.txt"),
               os.path.join(scene_dir, "dbg", "probability_heatmap.png"),
               os.path.join(scene_dir, "dbg", f"overlay_{obj}.png")]
    ckpt = os.path.join(root, "sweep.ckpt.npz")
    for f in [pose_file, ckpt] + ignored:
        if os.path.exists(f):
            os.remove(f)

    # the command writes the pose file only (as the JAX package's does):
    # the clusters are read from run_sweep's return values
    built, swept = [], []
    real_build = sampling.build_exists_bits
    real_sweep = estimator.StocsEstimator.run_sweep

    def counting_build(*a, **kw):
        bits = real_build(*a, **kw)
        built.append(tuple(bits.shape))
        return bits

    def recording_sweep(self, *a, **kw):
        out = real_sweep(self, *a, **kw)
        swept.append(out)
        return out

    sampling.build_exists_bits = counting_build
    estimator.StocsEstimator.run_sweep = recording_sweep
    log = _log_events()
    try:
        k_before = _kernel_launches()
        t0 = time.perf_counter()
        if cli.main(base) != 0:
            raise AssertionError("the sweep command failed")
        t_full = time.perf_counter() - t0
        counts = _kernel_launches(k_before)
        full = log.last("stocs_sweep")
        with open(pose_file) as f:
            pose_text = f.read()
        os.remove(pose_file)

        gathers, gates = _record_gathers(), _record_gates()
        sliced = base + ["--sweep-checkpoint", ckpt, "--sweep-stop-after", "1"]
        if cli.main(sliced) != 0 or not os.path.exists(ckpt):
            raise AssertionError("the stopped sweep left no checkpoint")
        gathers.stop()
        gates.stop()
        stopped = log.last("stocs_sweep")
        if stopped["completed"] or stopped["next_chunk"] != 1 or os.path.exists(pose_file):
            raise AssertionError(f"the sweep did not stop after one chunk: {stopped}")
        if cli.main(sliced) != 0:
            raise AssertionError("the resumed sweep failed")
        resumed = log.last("stocs_sweep")
    finally:
        sampling.build_exists_bits = real_build
        estimator.StocsEstimator.run_sweep = real_sweep
        log.stop()
    for w in log.warnings:
        print(f"warning logged: {w}")
    print(f"sweep: 4096 bases in chunks of 2048, command {t_full:.3f} s; launches "
          f"{json.dumps(counts)}; {full['bases_per_sec']:.1f} bases/s, "
          f"{full['hypotheses_per_sec']:.1f} hypotheses/s over {full['seconds']:.3f} s "
          f"({full['hypotheses']} hypotheses, best_lcp {full['best_lcp']:.6f}, "
          f"{full['clusters']} clusters, pair_count_max {full['pair_count_max']}); "
          f"existence matrix built {len(built)} times {built[:1]}")
    print(f"stopped after chunk 1: {stopped['total_bases']} bases in "
          f"{stopped['seconds']:.3f} s; resumed: {resumed['total_bases']} bases, "
          f"{resumed['seconds']:.3f} s in all, best_lcp {resumed['best_lcp']:.6f}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"the sweep missed a kernel: {counts}")
    if len(built) != 3 or built[0] != (cfg.max_scene_points, cfg.max_scene_points // 32):
        raise AssertionError(f"the sweeps did not build the existence matrix: {built}")
    if os.path.exists(ckpt):
        raise AssertionError("the completed sweep left its checkpoint behind")
    written = [f for f in ignored if os.path.exists(f)]
    if written:
        raise AssertionError(f"--sweep wrote what the JAX command does not: {written}")
    with open(pose_file) as f:
        same_pose = f.read() == pose_text
    (_l, _w, cl_t, cl_s, _st), _stop, (_l2, _w2, rcl_t, rcl_s, _st2) = swept
    same_clusters = np.array_equal(cl_t, rcl_t) and np.array_equal(cl_s, rcl_s)
    print(f"resumed == uninterrupted: pose file {same_pose}, clusters {same_clusters}, "
          f"hypotheses {resumed['hypotheses'] == full['hypotheses']}; no cluster, heatmap "
          f"or overlay file written under --sweep")
    if not (same_pose and same_clusters and resumed["completed"]
            and resumed["hypotheses"] == full["hypotheses"]
            and resumed["best_lcp"] == full["best_lcp"]):
        raise AssertionError("the resumed sweep differs from the uninterrupted one")
    capped = any("max_pairs_per_bin" in w for w in log.warnings)
    if full["pair_count_max"] > cfg.max_pairs_per_bin and not capped:
        raise AssertionError("a PPF bin was truncated and no warning was logged")
    cl_s = np.asarray(cl_s)
    if cl_s.shape[0] < 1 or np.asarray(cl_t).shape != (cl_s.shape[0], 4, 4):
        raise AssertionError("the sweep returned no cluster")
    if (np.diff(cl_s) > 0).any():
        raise AssertionError("the clusters are not in descending LCP order")
    if abs(cl_s[0] - full["pool_best_lcp"]) > 1e-5:
        raise AssertionError(
            f"the first cluster ({cl_s[0]}) is not the pool's best ({full['pool_best_lcp']})")
    paths = [os.path.join(scene_dir, n) for n in
             ("rgb.png", "depth.png", f"probability_maps/{obj}.png")]
    scene = load_scene(*paths, None, cfg, device=dev)
    _pose_file_on_scene(torch, dev, np, pose_file,
                        os.path.join(root, "models", obj, "model_search.ply"), scene, cfg)

    gate_rows = _check_recorded_gates(torch, gates.calls, dense_gate,
                                      dense_gate_reference, "sweep chunk")
    gather_rows, gather_err = _check_gathers(
        torch, _recorded_gather_cases(gathers.calls), time_repeats=False)
    gates.calls.clear()
    gathers.calls.clear()
    return dict(counts, gates=gate_rows, gate_max_abs_err=gate_rows["max_abs_err"],
                gathers=gather_rows, gather_max_abs_err=gather_err,
                bases_per_sec=full["bases_per_sec"],
                hypotheses_per_sec=full["hypotheses_per_sec"])


def _median_wall(torch, fn, runs=3):
    """Median host wall time of `runs` calls of fn, each ending in a
    synchronize, after one call to warm up; returns (seconds, the last
    result)."""
    out = fn()
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return sorted(walls)[runs // 2], out


def _multi_phase(torch, dev, dense_gate, dense_gate_reference, row_gather):
    import dataclasses

    import numpy as np

    from model_matching_tpu_torch import cli, multi
    from model_matching_tpu_torch.config import get_preset
    from model_matching_tpu_torch.model import load_model_pack
    from model_matching_tpu_torch.scene import load_scene_multi
    from model_matching_tpu_torch.synthetic import MULTI_SHELLS, write_synthetic_multi_scene

    root = os.path.join(_ROOT, "build", "chip_smoke_multi")
    shutil.rmtree(root, ignore_errors=True)
    objs = [name for name, *_ in MULTI_SHELLS]
    src = os.path.join(root, "class")
    scene_dir, cfg, gts = write_synthetic_multi_scene(src)
    edge_dir, _cfg, _gts = write_synthetic_multi_scene(os.path.join(root, "edge"), edge=True)
    if cfg != get_preset("ycb").match:
        raise AssertionError("the scene was not written at the ycb preset's camera")
    t0 = time.perf_counter()
    for obj in objs:
        if cli.main(["model-preprocess", obj, "--repo-path", src]) != 0:
            raise AssertionError(f"model-preprocess {obj} failed")
    print(f"model-preprocess of {len(objs)} objects {time.perf_counter() - t0:.3f} s")

    def paths(sdir):
        maps = os.path.join(sdir, "probability_maps")
        edge = os.path.join(maps, "edge.png")
        return (os.path.join(sdir, "rgb.png"), os.path.join(sdir, "depth.png"),
                [os.path.join(maps, f"{o}.png") for o in objs],
                edge if os.path.exists(edge) else None)

    def model_files(obj):
        mdir = os.path.join(src, "models", obj)
        return os.path.join(mdir, "model_search.ply"), os.path.join(mdir, "ppf_table.npz")

    models = [load_model_pack(*model_files(o), cfg.max_model_points, standardize=True,
                              device=dev) for o in objs]
    out = {"root": root, "src": src, "scene": scene_dir, "edge_scene": edge_dir,
           "objs": objs, "gts": gts, "cfg": cfg}
    gate_rows = gather_rows = None
    for path, sdir in (("class", scene_dir), ("edge", edge_dir)):
        log = _log_events()
        if path == "class":
            gathers, gates = _record_gathers(), _record_gates()
        k_before = _kernel_launches()
        t0 = time.perf_counter()
        rc = cli.main(["stocs-multi", sdir, ",".join(objs), "--repo-path", src])
        wall = time.perf_counter() - t0
        counts = _kernel_launches(k_before)
        if path == "class":
            gathers.stop()
            gates.stop()
        log.stop()
        for w in log.warnings:
            print(f"warning logged: {w}")
        if rc != 0:
            raise AssertionError(f"stocs-multi failed on the {path} scene")
        if min(counts.values()) <= 0:
            raise AssertionError(f"stocs-multi ({path}) missed a kernel: {counts}")
        scene, probs = load_scene_multi(*paths(sdir), cfg, device=dev)
        if scene.has_edge != (path == "edge"):
            raise AssertionError(f"the {path} scene loaded has_edge={scene.has_edge}")
        # the direct call on the same packs gives what the command wrote
        # (timed warm on the class path; once on the edge path, whose
        # sequential sampling takes seconds)
        if path == "class":
            t_call, (best, poses, nhyp) = _median_wall(
                torch, lambda: multi.match_all_objects(models, scene, probs, cfg), runs=1)
        else:
            t0 = time.perf_counter()
            best, poses, nhyp = multi.match_all_objects(models, scene, probs, cfg)
            t_call = time.perf_counter() - t0
        meds = []
        for o, obj in enumerate(objs):
            f = os.path.join(sdir, f"best_pose_candidate_{obj}.txt")
            # its own object's points: probability 0.9 there, 0.12 elsewhere
            med = _pose_file_on_scene(torch, dev, np, f, model_files(obj)[0], scene, cfg,
                                      own=probs[o] > 0.5)
            meds.append(med)
            with open(f) as fh:
                if fh.read().strip() != cli._pose_row(poses[o]):
                    raise AssertionError(f"{f} differs from the direct call's pose")
        keep = os.path.join(root, f"multi_{path}")
        os.makedirs(keep)
        for obj in objs:
            shutil.move(os.path.join(sdir, f"best_pose_candidate_{obj}.txt"), keep)
        out[path] = dict(counts, wall_s=wall, call_s=t_call, best_lcp=best.tolist(),
                         hypotheses=nhyp.tolist(), median_nn_m=meds, poses_dir=keep)
        print(f"stocs-multi {path}, {len(objs)} objects ({_gpu_name_and_limit()}): command "
              f"{wall:.3f} s, match_all_objects on loaded packs {t_call * 1e3:.3f} ms "
              f"({'warm: after a warm-up call' if path == 'class' else 'second call'}); launches "
              f"{json.dumps(counts)}; best_lcp {best.tolist()}, hypotheses "
              f"{nhyp.tolist()}; posed models {[round(m, 6) for m in meds]} m from their "
              f"objects (median NN, limit {1.5 * cfg.distance_threshold})")
        if path == "class":
            gate_rows = _check_recorded_gates(torch, gates.calls, dense_gate,
                                              dense_gate_reference, "multi")
            gather_rows, gather_err = _check_gathers(
                torch, _recorded_gather_cases(gathers.calls), time_repeats=False)
            gates.calls.clear()
            gathers.calls.clear()
            # per object: alone in a call (object 0 keeps its key, so its row
            # must come back bit for bit), and each row with the others'
            # priors zeroed
            alone = []
            for o in range(len(objs)):
                t_o, (b1, p1, n1) = _median_wall(
                    torch, lambda: multi.match_all_objects(
                        [models[o]], scene, probs[o:o + 1], cfg), runs=1)
                alone.append(t_o)
                if o == 0 and not (b1[0] == best[0] and n1[0] == nhyp[0]
                                   and np.array_equal(p1[0], poses[0])):
                    raise AssertionError("object 0 alone differs from its row")
                solo = torch.zeros_like(probs)
                solo[o] = probs[o]
                b2, p2, n2 = multi.match_all_objects(models, scene, solo, cfg)
                if not (b2[o] == best[o] and n2[o] == nhyp[o]
                        and np.array_equal(p2[o], poses[o])):
                    raise AssertionError(f"object {o}'s row moved when the other "
                                         f"priors were zeroed")
            out["alone_s"] = alone
            print(f"per object alone, warm ({_gpu_name_and_limit()}): "
                  f"{[round(t * 1e3, 3) for t in alone]} ms; object 0 alone and every "
                  f"row with the other priors zeroed equal to the three-object call")

    # the card against the CPU on the small configuration
    small = os.path.join(root, "small")
    small_dir, small_cfg, _g = write_synthetic_multi_scene(small, scale=0.25)
    small_cfg = dataclasses.replace(
        small_cfg, number_of_bases=16, voxel_size=0.01, max_scene_points=4096,
        max_pairs_per_bin=2048, maximum_congruent_sets=64)
    res = {}
    for d in ("cpu", dev):
        sc, pr = load_scene_multi(*paths(small_dir), small_cfg, device=d)
        res[str(d)] = multi.match_all_objects([m.to(d) for m in models], sc, pr, small_cfg)
    (bc, pc, nc), (bg, pg, ng) = res["cpu"], res[str(dev)]
    pose_err = float(np.abs(pc - pg).max())
    print(f"160x120, 16 bases, 3 objects: card against CPU: hypotheses cpu {nc.tolist()} "
          f"cuda {ng.tolist()}; best_lcp cpu {bc.tolist()} cuda {bg.tolist()}; pose max "
          f"abs diff {pose_err:.3e}")
    if (not np.array_equal(nc, ng) or float(np.abs(bc - bg).max()) > 1e-5
            or pose_err > 1e-4 or not (nc > 0).all()):
        raise AssertionError("the multi-object path on the card disagrees with the CPU")
    return dict(out, gates=gate_rows, gate_max_abs_err=gate_rows["max_abs_err"],
                gathers=gather_rows, gather_max_abs_err=gather_err)


def _sharded_phase(torch, dev, dense_gate, dense_gate_reference, row_gather, multi, sweep):
    """parallel/*, multi(mesh=) and native on the card: eight ranks on cuda:0
    (a rank's share runs after the one before it). `sweep` is phase 9's
    result: the one-device sweep of the same scene and budget, in this
    call."""
    import numpy as np

    from model_matching_tpu_torch import cli, native
    from model_matching_tpu_torch import multi as multi_mod
    from model_matching_tpu_torch.config import get_preset
    from model_matching_tpu_torch.model import load_model_pack
    from model_matching_tpu_torch.parallel import dcn_worker
    from model_matching_tpu_torch.parallel.sharding import make_mesh, run_sweep_sharded
    from model_matching_tpu_torch.scene import load_scene, load_scene_multi

    obj = "synthetic_shell"
    cfg = get_preset("ycb").match
    gpu = _gpu_name_and_limit()

    def packs(root, edge):
        sdir = os.path.join(root, "scene")
        maps = os.path.join(sdir, "probability_maps")
        mdir = os.path.join(root, "models", obj)
        model = load_model_pack(os.path.join(mdir, "model_search.ply"),
                                os.path.join(mdir, "ppf_table.npz"), cfg.max_model_points,
                                device=dev)
        scene = load_scene(os.path.join(sdir, "rgb.png"), os.path.join(sdir, "depth.png"),
                           os.path.join(maps, f"{obj}.png"),
                           os.path.join(maps, "edge.png") if edge else None, cfg, device=dev)
        return model, scene, os.path.join(mdir, "model_search.ply")

    # the class sweep of phase 9 at full width, over 8 ranks: 256 bases a
    # rank a chunk
    files = os.path.join(_ROOT, "build", "chip_smoke_files")
    model, scene, model_ply = packs(files, False)
    mesh = make_mesh([dev] * 8)
    kw = dict(chunk=2048, verbose=False)
    log = _log_events()
    gathers, gates = _record_gathers(), _record_gates()
    k_before = _kernel_launches()
    try:
        full = run_sweep_sharded(mesh, model, scene, cfg, 4096, **kw)
        counts = _kernel_launches(k_before)
    finally:
        gathers.stop()
        gates.stop()
        log.stop()
    st = full[4]
    for w in log.warnings:
        print(f"warning logged: {w}")
    print(f"sharded sweep, 4096 bases in chunks of 2048 over {st['devices']} ranks on "
          f"{dev} ({gpu}): {st['bases_per_sec']:.1f} bases/s, "
          f"{st['hypotheses_per_sec']:.1f} hypotheses/s over {st['seconds']:.3f} s "
          f"({st['hypotheses']} hypotheses, best_lcp {full[0]:.6f}, {len(full[3])} clusters, "
          f"pair_count_max {st['pair_count_max']}); launches {json.dumps(counts)}; the "
          f"one-device sweep of phase 9 in this call {sweep['bases_per_sec']:.1f} bases/s, "
          f"{sweep['hypotheses_per_sec']:.1f} hypotheses/s")
    if st["devices"] != 8 or not st["completed"] or min(counts.values()) <= 0:
        raise AssertionError(f"the sharded sweep missed a kernel or a rank: {st}, {counts}")
    if st["pair_count_max"] > cfg.max_pairs_per_bin and not any(
            "max_pairs_per_bin" in w for w in log.warnings):
        raise AssertionError("a PPF bin was truncated and no warning was logged")
    cl_s = np.asarray(full[3])
    if cl_s.shape[0] < 1 or (np.diff(cl_s) > 0).any():
        raise AssertionError("the sharded sweep's clusters are missing or out of order")
    pose_path = os.path.join(files, "sharded_best_pose.txt")
    cli._write_pose(pose_path, full[1])
    _pose_file_on_scene(torch, dev, np, pose_path, model_ply, scene, cfg)
    gate_rows = _check_recorded_gates(torch, gates.calls, dense_gate, dense_gate_reference,
                                      "sharded sweep")
    gather_rows, gather_err = _check_gathers(
        torch, _recorded_gather_cases(gathers.calls), time_repeats=False)
    gates.calls.clear()
    gathers.calls.clear()

    # stopped after a chunk, refused under another rank count, resumed
    ck = os.path.join(files, "sharded.ckpt.npz")
    if os.path.exists(ck):
        os.remove(ck)
    part = run_sweep_sharded(mesh, model, scene, cfg, 4096, **kw, checkpoint_path=ck,
                             stop_after_chunks=1)
    if part[4]["completed"] or not os.path.exists(ck):
        raise AssertionError("the stopped sharded sweep left no checkpoint")
    try:
        run_sweep_sharded(make_mesh([dev] * 4), model, scene, cfg, 4096, **kw,
                          checkpoint_path=ck)
    except ValueError as e:
        if "device layout" not in str(e):
            raise
        print(f"resume over 4 ranks refused: {e}")
    else:
        raise AssertionError("a resume over 4 ranks of an 8-rank checkpoint ran")
    resumed = run_sweep_sharded(mesh, model, scene, cfg, 4096, **kw, checkpoint_path=ck)
    same = (resumed[0] == full[0] and resumed[4]["hypotheses"] == st["hypotheses"]
            and all(np.array_equal(a, b) for a, b in zip(resumed[1:4], full[1:4])))
    print(f"sharded sweep stopped after chunk 1 and resumed: equal to the uninterrupted "
          f"one bit for bit: {same}; checkpoint removed: {not os.path.exists(ck)}")
    if not same or os.path.exists(ck):
        raise AssertionError("the resumed sharded sweep differs from the uninterrupted one")

    # the instance path on phase 8's edge scene: 256 bases over 8 ranks
    emodel, escene, emodel_ply = packs(os.path.join(_ROOT, "build", "chip_smoke_instance"),
                                       True)
    k_before = _kernel_launches()
    inst = run_sweep_sharded(mesh, emodel, escene, cfg, 256, chunk=256, verbose=False)
    icounts = _kernel_launches(k_before)
    ist = inst[4]
    print(f"sharded instance sweep, 256 bases over 8 ranks ({gpu}): {ist['seconds']:.3f} s, "
          f"{ist['bases_per_sec']:.1f} bases/s ({ist['hypotheses']} hypotheses, best_lcp "
          f"{inst[0]:.6f}); launches {json.dumps(icounts)}")
    if min(icounts.values()) <= 0 or ist["hypotheses"] <= 0:
        raise AssertionError(f"the sharded instance sweep missed a kernel: {icounts}")
    cli._write_pose(pose_path, inst[1])
    _pose_file_on_scene(torch, dev, np, pose_path, emodel_ply, escene, cfg)

    # two processes of one rank each on this card, against one process of two
    t0 = time.perf_counter()
    procs = dcn_worker.launch(2, 1, out_dir=os.path.join(_ROOT, "build", "chip_smoke_dcn"),
                              device="cuda", timeout=300)
    t_launch = time.perf_counter() - t0
    t0 = time.perf_counter()
    alone = dcn_worker.run_workload(make_mesh([dev] * 2), dev)
    t_alone = time.perf_counter() - t0
    # what a process counts of its own (its collectives and bytes, its
    # ranks' hypotheses before the gather) differs with the layout; the
    # answers and the reduction's counts do not
    own = ("global_devices", "collectives", "collective_bytes", "sweep_local_hyp")
    keys = [k for k in alone if k not in own]
    agree = (all(procs[0][k] == procs[1][k] == alone[k] for k in keys)
             and [p["process_id"] for p in procs] == [0, 1]
             and procs[0]["sweep_local_hyp"] + procs[1]["sweep_local_hyp"]
             == alone["sweep_local_hyp"])
    print(f"dcn_worker.launch(2, 1) on {dev} ({gpu}): {t_launch:.3f} s (processes started, "
          f"joined over gloo, workload run); one process of 2 ranks {t_alone:.3f} s; both "
          f"processes equal to it: {agree} (step_best {alone['step_best']:.6f}, sweep_best "
          f"{alone['sweep_best']:.6f}, instance_best {alone['instance_best']:.6f})")
    if not agree or procs[0]["process_count"] != 2 or procs[0]["global_devices"] != 2:
        raise AssertionError(f"the two processes disagree: {procs}, {alone}")

    # three objects over a mesh of two ranks: padded to four, equal bit for bit
    objs, src, mcfg = multi["objs"], multi["src"], multi["cfg"]
    models = [load_model_pack(os.path.join(src, "models", o, "model_search.ply"),
                              os.path.join(src, "models", o, "ppf_table.npz"),
                              mcfg.max_model_points, standardize=True, device=dev)
              for o in objs]
    maps = os.path.join(multi["scene"], "probability_maps")
    mscene, probs = load_scene_multi(os.path.join(multi["scene"], "rgb.png"),
                                     os.path.join(multi["scene"], "depth.png"),
                                     [os.path.join(maps, f"{o}.png") for o in objs], None,
                                     mcfg, device=dev)
    ref = multi_mod.match_all_objects(models, mscene, probs, mcfg)
    t_mesh, got = _median_wall(torch, lambda: multi_mod.match_all_objects(
        models, mscene, probs, mcfg, mesh=make_mesh([dev] * 2)), runs=1)
    same = all(np.array_equal(a, b) for a, b in zip(got, ref))
    print(f"match_all_objects over 2 ranks on {dev}: {t_mesh * 1e3:.3f} ms; equal to "
          f"mesh=None bit for bit: {same}")
    if not same:
        raise AssertionError("match_all_objects(mesh=2 ranks) differs from mesh=None")

    # the host C++ helpers: built, and model-preprocess with and without them
    if not native.available():
        raise AssertionError("the native host helpers did not build")
    walls, tables = {}, {}
    for mode in ("native", "numpy"):
        out_root = os.path.join(_ROOT, "build", "chip_smoke_preprocess", mode)
        shutil.rmtree(out_root, ignore_errors=True)
        if mode == "numpy":
            os.environ["MM_NO_NATIVE"] = "1"
        try:
            t0 = time.perf_counter()
            rc = cli.main(["model-preprocess", obj, "--repo-path", files,
                           "--output-root", out_root])
            walls[mode] = time.perf_counter() - t0
        finally:
            os.environ.pop("MM_NO_NATIVE", None)
        if rc != 0:
            raise AssertionError(f"model-preprocess ({mode}) failed")
        tables[mode] = _pair_keys(os.path.join(out_root, "models", obj, "ppf_table.npz"))
    # the C++ and the numpy float paths round apart at a few bin boundaries
    differ = int((tables["native"] != tables["numpy"]).sum())
    print(f"model-preprocess ({gpu}): with the native helpers {walls['native']:.3f} s, "
          f"with MM_NO_NATIVE=1 {walls['numpy']:.3f} s; {differ} of "
          f"{tables['native'].size} pair keys differ between the two tables")
    if tables["native"].shape != tables["numpy"].shape or differ > 1e-4 * tables["native"].size:
        raise AssertionError("model-preprocess wrote another table without the helpers")
    return dict(counts, instance=icounts, gates=gate_rows,
                gate_max_abs_err=gate_rows["max_abs_err"], gathers=gather_rows,
                gather_max_abs_err=gather_err, bases_per_sec=st["bases_per_sec"],
                one_device_bases_per_sec=sweep["bases_per_sec"])


def _pair_keys(path):
    """The PPF key of every (p, q) model pair of a ppf_table.npz, [M, M]
    int64 (-1 where no pair is stored)."""
    import numpy as np

    with np.load(path) as z:
        keys, off, cnt, pairs = (z[k].astype(np.int64) for k in
                                 ("bin_keys", "bin_offset", "bin_count", "pairs"))
    occ = keys >= 0
    key_of_row = np.repeat(keys[occ], cnt[occ])
    rows = np.concatenate([np.arange(o, o + c) for o, c in zip(off[occ], cnt[occ])])
    m = int(pairs.max()) + 1
    out = np.full((m, m), -1, np.int64)
    out[pairs[rows, 0], pairs[rows, 1]] = key_of_row
    return out


def _standardized_row(dev, src, scene_dir, obj, cfg):
    """The OK line that serve gives for one request: the estimator on the
    object's standardized pack and the scene."""
    from model_matching_tpu_torch import cli
    from model_matching_tpu_torch.estimator import StocsEstimator
    from model_matching_tpu_torch.model import load_model_pack
    from model_matching_tpu_torch.scene import load_scene

    mdir = os.path.join(src, "models", obj)
    model = load_model_pack(os.path.join(mdir, "model_search.ply"),
                            os.path.join(mdir, "ppf_table.npz"), cfg.max_model_points,
                            standardize=True, device=dev)
    scene = load_scene(*[os.path.join(scene_dir, n) for n in
                         ("rgb.png", "depth.png", f"probability_maps/{obj}.png")],
                       None, cfg, device=dev)
    res = StocsEstimator(model, scene, cfg).run(verbose=False)
    return f"OK {cli._pose_row(res.best_world_transform)} {res.best_lcp:g}"


def _commands_phase(torch, dev, multi):
    import numpy as np

    from model_matching_tpu_torch import cli

    src, scene_dir, edge_dir = multi["src"], multi["scene"], multi["edge_scene"]
    objs, root = multi["objs"], multi["root"]

    def pose_files(sdir, names):
        texts = {}
        for obj in names:
            f = os.path.join(sdir, f"best_pose_candidate_{obj}.txt")
            with open(f) as fh:
                texts[obj] = fh.read()
            os.remove(f)
        return texts

    # stocs-single once per object, then stocs-batch of all three
    single_s = []
    for obj in objs:
        t0 = time.perf_counter()
        if cli.main(["stocs-single", scene_dir, obj, "--repo-path", src]) != 0:
            raise AssertionError(f"stocs-single {obj} failed")
        single_s.append(time.perf_counter() - t0)
    single = pose_files(scene_dir, objs)
    single_dir = os.path.join(root, "single")
    os.makedirs(single_dir)
    for obj, text in single.items():
        with open(os.path.join(single_dir, f"best_pose_candidate_{obj}.txt"), "w") as f:
            f.write(text)
    t0 = time.perf_counter()
    if cli.main(["stocs-batch", scene_dir, ",".join(objs), "--repo-path", src]) != 0:
        raise AssertionError("stocs-batch failed")
    batch_s = time.perf_counter() - t0
    batch = pose_files(scene_dir, objs)
    if batch != single:
        raise AssertionError("stocs-batch wrote other pose files than stocs-single")
    if cli.main(["stocs-single", edge_dir, objs[0], "--repo-path", src]) != 0:
        raise AssertionError("stocs-single failed on the edge scene")
    edge_single = pose_files(edge_dir, objs[:1])[objs[0]]
    m = multi["class"]
    print(f"stocs-single x {len(objs)} ({_gpu_name_and_limit()}): "
          f"{[round(t, 3) for t in single_s]} s, {sum(single_s):.3f} s in all; stocs-batch "
          f"{batch_s:.3f} s, pose files equal to stocs-single's; stocs-multi command "
          f"{m['wall_s']:.3f} s, warm match_all_objects {m['call_s'] * 1e3:.3f} ms")

    # serve in a fresh process: four requests and quit
    reqs = [f"{scene_dir} {o}" for o in objs[:2]] + [f"{edge_dir} {objs[0]}",
                                                 "a bad request line", "quit"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "model_matching_tpu_torch.cli", "serve", "--repo-path", src],
        input="\n".join(reqs) + "\n", capture_output=True, text=True, timeout=600,
        cwd=_ROOT)
    serve_s = time.perf_counter() - t0
    lines = [l for l in proc.stdout.splitlines() if l == "READY" or l.startswith(("OK", "ERR"))]
    events = [json.loads(l.split(" INFO ", 1)[1]) for l in proc.stderr.splitlines()
              if l.startswith("[mm-torch] INFO {")]
    events = [e for e in events if e.get("event") == "serve_request"]
    if proc.returncode != 0 or [l.split()[0] for l in lines] != [
            "READY", "OK", "OK", "OK", "ERR"]:
        raise AssertionError(f"serve answered {lines} (rc {proc.returncode}):\n"
                             f"{proc.stderr[-4000:]}")
    # serve loads the packs standardized, as the JAX package's serve does:
    # its rows are the estimator's on a standardized pack (the first one
    # recomputed here, byte for byte) and within 1e-4 of the stocs-single
    # files, which load the packs unpadded
    want = [single[o].strip() for o in objs[:2]] + [edge_single.strip()]
    pose_err = 0.0
    for line, row in zip(lines[1:4], want):
        got = np.array(line.split()[1:13], float)
        pose_err = max(pose_err, float(np.abs(got - np.array(row.split(), float)).max()))
    if pose_err > 1e-4:
        raise AssertionError(f"serve's poses differ from the stocs-single files by {pose_err}")
    first = _standardized_row(dev, src, scene_dir, objs[0], multi["cfg"])
    if lines[1] != first:
        raise AssertionError(f"serve answered {lines[1]!r}, the estimator on the "
                             f"standardized pack gives {first!r}")
    if lines[4] != "ERR usage: <scene_path> <object>" or len(events) != 3:
        raise AssertionError(f"serve's error line or events are wrong: {lines[4]}, {events}")
    if any(e["kernels_loaded"] or e["kernels_built"] for e in events[1:]) or any(
            e["kernels_built"] for e in events):
        raise AssertionError(f"serve loaded or built kernels after its first request: {events}")
    print(f"serve in a fresh process ({_gpu_name_and_limit()}): {serve_s:.3f} s in all; "
          f"first request {events[0]['seconds'] * 1e3:.3f} ms (kernels loaded "
          f"{events[0]['kernels_loaded']}, model loaded {events[0]['model_loaded']}), "
          f"then {[round(e['seconds'] * 1e3, 3) for e in events[1:]]} ms (the last on "
          f"the edge scene); OK rows within {pose_err:.2e} of the stocs-single files, the "
          f"first equal to the estimator's on the standardized pack; no kernel load or "
          f"build after the first request")

    # eval: ADD-S of the stocs-multi poses (pose files) and of the
    # stocs-single poses (BOP scene_gt.json) against the written truth
    gt_dir = os.path.join(src, "gt")
    evals = {}
    for i, obj in enumerate(objs):
        model = os.path.join(src, "models", obj, "textured_vertices.ply")
        name = f"best_pose_candidate_{obj}.txt"
        for what, est, gt in (
                ("multi", os.path.join(multi["class"]["poses_dir"], name),
                 [os.path.join(gt_dir, name)]),
                ("single", os.path.join(single_dir, name),
                 [os.path.join(gt_dir, "scene_gt.json"), "--im-id", "0",
                  "--obj-id", str(i + 1)])):
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = cli.main(["eval", est, *gt, "--model", model])
            report = json.loads(text.getvalue())
            if rc != 0 or report["adds_pass_rate"] != 1.0:
                raise AssertionError(f"eval of the {what} pose of {obj}: {report}")
            evals[f"{what} {obj}"] = (report["adds_mean"], report["threshold"])
    print("eval, ADD-S mean / threshold (m): " + json.dumps(
        {k: [round(v, 6) for v in vs] for k, vs in evals.items()}))

    # --profile
    prof_dir = os.path.join(root, "profile")
    if cli.main(["stocs-single", scene_dir, objs[0], "--repo-path", src,
                 "--profile", prof_dir]) != 0:
        raise AssertionError("stocs-single --profile failed")
    traces = [f for f in os.listdir(prof_dir) if f.endswith(".json")]
    if len(traces) != 1:
        raise AssertionError(f"--profile wrote {traces}")
    with open(os.path.join(prof_dir, traces[0])) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    found = {k: sum(k in n for n in names) for k in ("dense_gate_kernel", "row_gather")}
    print(f"--profile trace {traces[0]}: {len(names)} events; kernel events {found}")
    if min(found.values()) <= 0:
        raise AssertionError(f"the profile trace does not name both kernels: {found}")


def _gate_launch_rows(torch, calls, dense_gate, dense_gate_reference, where):
    """Each recorded dense-gate launch timed on the device (CUDA events,
    3 runs behind a device spin) beside its bound (_gate_bound, from the
    launch's own inputs) and the plain version's time on one base."""
    rows = []
    for args, kw in calls:
        b, p, q = args[2].shape[0], args[2].shape[1], args[3].shape[1]
        ms = _device_ms(torch, lambda: dense_gate(*args, **kw), runs=3)
        one_args, one_kw = _slice_bases(args, kw, [0])
        plain_ms = _time_ms(torch, lambda: dense_gate_reference(*one_args, **one_kw), runs=1)
        live = kw.get("live")
        row = {"bases": b, "p": p, "q": q, "q_tile": kw["q_tile"], "ms": ms,
               "ms_per_base": ms / b, "plain_ms_one_base": plain_ms,
               "live_share": None if live is None else float(live.float().mean())}
        row.update(_gate_bound(torch, dense_gate_reference, args, kw, ms))
        rows.append(row)
        print(f"{where} launch {b} bases P={p} Q={q} q_tile={kw['q_tile']} live="
              f"{'-' if live is None else round(row['live_share'], 4)}: kernel {ms:.4f} ms "
              f"on the device ({ms / b:.4f} ms a base), plain {plain_ms:.4f} ms for one "
              f"base; {_bound_text(row)} ({_gpu_name_and_limit()})")
    return rows


def _on_a_box(np, pose, boxes, where):
    """A 3x4 pose on one of the packed scene's boxes: centre within 1 cm,
    axes along the box's up to its symmetries. Returns (box, distance)."""
    r = pose[:, :3]
    if not np.allclose(r @ r.T, np.eye(3), atol=1e-4) or abs(np.linalg.det(r) - 1) > 1e-4:
        raise AssertionError(f"{where}: the pose's rotation is not orthonormal")
    dist = [float(np.linalg.norm(g[:3, 3] - pose[:, 3])) for g in boxes]
    k = int(np.argmin(dist))
    axes = float(np.abs(np.abs(boxes[k][:3, :3].T @ r) - np.eye(3)).max())
    if dist[k] > 0.01 or axes > 0.2:
        raise AssertionError(f"{where}: the pose is on no box (nearest {k} at "
                             f"{dist[k]:.4f} m, axes off by {axes:.3f})")
    return k, dist[k]


def _to_cpu(x):
    """Tensors, packs and tuples of them on the CPU (packs by their .to)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if hasattr(x, "_fields"):
        return type(x)(*(_to_cpu(v) for v in x))
    if hasattr(x, "to"):
        return x.to("cpu")
    return x


def _same_args(torch, a, b):
    """Dense-gate arguments equal, tensors bit for bit (b on the card)."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b.cpu())
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_args(torch, x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_args(torch, a[k], b[k]) for k in a)
    return a == b


def _presets_phase(torch, dev, dense_gate, dense_gate_reference, row_gather):
    """The packed and linemod presets at full width (phase 14)."""
    packed = _packed_phase(torch, dev, dense_gate, dense_gate_reference, row_gather)
    packed["sweep"] = _packed_sweep(torch, dev, dense_gate, dense_gate_reference,
                                    row_gather, packed)
    packed["block"] = _packed_block_mode(torch, dev, dense_gate, dense_gate_reference,
                                         row_gather, packed)
    packed["linemod"] = _linemod_phase(torch, dev, dense_gate, dense_gate_reference,
                                       row_gather)
    return packed


def _packed_phase(torch, dev, dense_gate, dense_gate_reference, row_gather):
    import dataclasses

    import numpy as np

    from model_matching_tpu_torch import cli, congruent
    from model_matching_tpu_torch import estimator as est_mod
    from model_matching_tpu_torch.config import get_preset
    from model_matching_tpu_torch.model import load_model_pack
    from model_matching_tpu_torch.scene import load_scene
    from model_matching_tpu_torch.synthetic import write_synthetic_packed_scene

    root = os.path.join(_ROOT, "build", "chip_smoke_packed")
    shutil.rmtree(root, ignore_errors=True)
    obj = "packed_box"
    scene_dir, cfg, boxes = write_synthetic_packed_scene(root, obj)
    if cfg != get_preset("packed").match:
        raise AssertionError("the scene was not written at the packed preset's camera")
    t0 = time.perf_counter()
    if cli.main(["model-preprocess", obj, "--repo-path", root, "--preset", "packed"]) != 0:
        raise AssertionError("model-preprocess --preset packed failed")
    t_pre = time.perf_counter() - t0
    mdir = os.path.join(root, "models", obj)
    model_files = (os.path.join(mdir, "model_search.ply"), os.path.join(mdir, "ppf_table.npz"))
    model = load_model_pack(*model_files, cfg.max_model_points, device=dev)
    most, bins = densest_bin_union(model.table)
    top_cap = congruent.tier_plan(cfg.max_pairs_per_bin)[0][-1][0]
    lanes = congruent._tier_shape(cfg.max_pairs_per_bin, 4096, model.pair_ep)[0]
    print(f"packed: model-preprocess {t_pre:.3f} s, |M| = {int(model.valid.sum())}; the "
          f"densest PPF bin union of the box holds {most} pairs (query bins "
          f"{bins.tolist()}): over the {top_cap}-pair tier, so bases reach the "
          f"{cfg.max_pairs_per_bin}-pair top tier ({lanes} lanes)")
    if not top_cap < most <= cfg.max_pairs_per_bin:
        raise AssertionError("the box's bins do not reach the top tier alone")

    # the command, with the sampler's, congruent step's and dense gate's
    # inputs and outputs recorded
    log = _log_events()
    gathers, gates = _record_gathers(), _record_gates(keep_outputs=True)
    rec = {"inst": [], "cong": []}
    real_s, real_c = est_mod._phase_sample_instance, est_mod._run_congruent

    def sample(*a, **kw):
        out = real_s(*a, **kw)
        rec["inst"].append((a, kw, out))
        return out

    def cong(*a, **kw):
        out = real_c(*a, **kw)
        rec["cong"].append((a, kw, out))
        return out

    est_mod._phase_sample_instance, est_mod._run_congruent = sample, cong
    k_before, g_before = _kernel_launches(), _graph_counts()
    try:
        t0 = time.perf_counter()
        rc = cli.main(["stocs-single", scene_dir, obj, "--repo-path", root,
                       "--preset", "packed"])
        t_single = time.perf_counter() - t0
    finally:
        est_mod._phase_sample_instance, est_mod._run_congruent = real_s, real_c
        gathers.stop()
        gates.stop()
        log.stop()
    counts, graphs = _kernel_launches(k_before), _graph_counts(g_before)
    if rc != 0:
        raise AssertionError("stocs-single --preset packed failed")
    run = log.last("stocs_run")
    for w in log.warnings:
        print(f"warning logged: {w}")
    (s_args, s_kw, inst), = rec["inst"]
    (c_args, c_kw, sets), = rec["cong"]
    pair_max = int(sets.pair_counts.max())
    short = int(congruent.selection_shortfall(sets, cfg))
    print(f"packed: stocs-single {t_single:.3f} s (first run of the preset); launches "
          f"{json.dumps(counts)}; phases_ms {json.dumps(run['timings_ms'])}; best_lcp "
          f"{run['best_lcp']:.6f}, {run['bases']} bases, {run['hypotheses']} hypotheses; "
          f"pair_count_max {pair_max}, selection_shortfall {short}, unconverged fills "
          f"{run['unconverged_fills']}; sample_bases "
          f"{run['timings_ms']['sample_bases'] / 1e3:.4f} s, graphs {json.dumps(graphs)}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"the packed path missed a kernel: {counts}")
    _check_graph_counts(graphs, cfg.number_of_bases, 3, "packed stocs-single")
    top = [(a, kw) for a, kw in gates.calls
           if a[2].shape[1] == lanes and kw.get("live") is not None]
    if not top:
        raise AssertionError(f"no dense-gate launch at P=Q={lanes} with a live mask: "
                             f"{[tuple(a[2].shape) for a, _kw in gates.calls]}")
    for a, kw in top:
        live = kw["live"]
        if a[3].shape[1] != lanes or bool(live.all()):
            raise AssertionError(f"the top-tier launch is not square or has no dead tile")
        print(f"packed top tier: {a[2].shape[0]} bases at P=Q={lanes}, live {list(live.shape)}: "
              f"{float(live.float().mean()) * 100:.2f}% of the (P tile, Q chunk) pairs live")

    scene = load_scene(*[os.path.join(scene_dir, n) for n in (
        "rgb.png", "depth.png", f"probability_maps/{obj}.png", "probability_maps/edge.png")],
        cfg, device=dev)
    pose_file = os.path.join(scene_dir, f"best_pose_candidate_{obj}.txt")
    _pose_file_on_scene(torch, dev, np, pose_file, model_files[0], scene, cfg)
    k, d = _on_a_box(np, np.loadtxt(pose_file).reshape(3, 4), boxes, "packed stocs-single")
    print(f"packed: the pose is on box {k} (centre {d * 1e3:.2f} mm away)")

    # the kernels against their plain versions on this run's launches, each
    # launch timed beside its bound
    gate_rows = _check_recorded_gates(torch, gates.calls, dense_gate,
                                      dense_gate_reference, "packed")
    straddle = _straddling_blocks(torch, top[0], dense_gate, dense_gate_reference)
    launch_rows = _gate_launch_rows(torch, gates.calls, dense_gate, dense_gate_reference,
                                    "packed")
    gather_rows, gather_err = _check_gathers(
        torch, _recorded_gather_cases(gathers.calls), time_repeats=False)
    gathers.calls.clear()

    # the card against the port on the CPU at full width: the sampler on the
    # recorded inputs; congruent extraction on the recorded bases, the CPU's
    # dense gate replaced by the card's outputs of the same launch (held to
    # the plain version above) after its inputs were found equal to the
    # card's: the cell sort, its permutation, the live mask, the selection,
    # the totals and selection_shortfall
    t0 = time.perf_counter()
    inst_cpu = real_s(*[_to_cpu(a) for a in s_args], **s_kw)
    for f in inst._fields:
        if not torch.equal(getattr(inst, f).cpu(), getattr(inst_cpu, f)):
            raise AssertionError(f"packed: the sampler's {f} differs card against CPU")
    t_inst = time.perf_counter() - t0
    replay = list(zip(gates.calls, gates.outputs))

    def replayed(*args, **kw):
        (g_args, g_kw), g_out = replay.pop(0)
        if not (_same_args(torch, args, g_args) and _same_args(torch, kw, g_kw)):
            raise AssertionError("packed: a dense-gate launch's inputs differ card "
                                 "against CPU (cell sort, live mask or features)")
        return tuple(t.cpu() for t in g_out)

    congruent.dense_gate = replayed
    try:
        t0 = time.perf_counter()
        sets_cpu = real_c(*[_to_cpu(a) for a in c_args], **c_kw)
    finally:
        congruent.dense_gate = gates._real
    if replay:
        raise AssertionError("packed: the CPU made fewer dense-gate launches than the card")
    for f in sets._fields:
        if not torch.equal(getattr(sets, f).cpu(), getattr(sets_cpu, f)):
            raise AssertionError(f"packed: congruent {f} differs card against CPU")
    short_cpu = int(congruent.selection_shortfall(sets_cpu, cfg))
    if short_cpu != short:
        raise AssertionError("packed: selection_shortfall differs card against CPU")
    print(f"packed at full width, card against CPU: {int(inst.valid.sum())} instance bases, "
          f"masks, decayed prior equal (CPU {t_inst:.3f} s); {len(gates.calls)} dense-gate "
          f"launches with equal inputs (sorted cells, features, live masks); pairs, "
          f"quad_valid, totals ({int(sets.total_found.sum())}) and pair counts equal; "
          f"selection_shortfall {short} on both (CPU {time.perf_counter() - t0:.3f} s)")
    gates.calls.clear()
    gates.outputs.clear()

    small = _packed_small(torch, dev, model, cfg, root, obj)
    return dict(counts, root=root, scene_dir=scene_dir, obj=obj, cfg=cfg, boxes=boxes,
                model_files=model_files, densest_union=most, lanes=lanes, straddle=straddle,
                pair_count_max=pair_max, selection_shortfall=short,
                gates=gate_rows, launch_rows=launch_rows,
                gate_max_abs_err=gate_rows["max_abs_err"], gathers=gather_rows,
                gather_max_abs_err=gather_err, phases_ms=run["timings_ms"],
                graphs=graphs, wall_s=t_single, small=small)


def densest_bin_union(table):
    """The most pairs that one query's 128-way fan-out (`lookup_pair_range`)
    can gather from `table`, over every query a scene pair can make, and
    the query bins [4] that gather them: (pairs, bins). Congruent
    extraction sends a base to its top tier when a side gathers more pairs
    than the tier below holds, so this says whether a model can reach
    that tier at all. Counted on the host over the dense grid of key
    coordinates: each query's union is the sum of the exact bins' counts
    at its 128 source offsets."""
    import numpy as np

    from model_matching_tpu_torch.ops.ppf import MIN_DISTANCE_BIN_MM, fanout_deltas
    from model_matching_tpu_torch.ppf_table import unpack_key_np

    keys = table.bin_keys.cpu().numpy()
    occ = keys >= 0
    disc = np.array([table.tr_disc] + [table.rot_disc] * 3)
    coords = unpack_key_np(keys[occ], table.tr_disc, table.rot_disc) // disc
    pad = 3                           # the offsets reach 2 below and 1 above
    grid = np.zeros(coords.max(0) + 2 * pad + 1, np.int64)
    np.add.at(grid, tuple((coords + pad).T),
              table.bin_count.cpu().numpy()[occ].astype(np.int64))
    union = np.zeros_like(grid)
    for d in fanout_deltas(table.tr_disc, table.rot_disc):
        union += np.roll(grid, shift=tuple(d), axis=(0, 1, 2, 3))
    # queries that exist: a distance above the minimum bin, angles in
    # [0, 180] degrees
    q = [np.arange(n) - pad for n in grid.shape]
    ok = ((q[0] * table.tr_disc > MIN_DISTANCE_BIN_MM)[:, None, None, None]
          & np.logical_and.reduce(np.meshgrid(
              *[(a >= 0) & (a * table.rot_disc <= 180) for a in q[1:]],
              indexing="ij"))[None])
    union = np.where(ok, union, 0)
    best = np.unravel_index(int(np.argmax(union)), union.shape)
    bins = (np.array(best) - pad) * disc
    return int(union[best]), bins.astype(np.int32)


def _straddling_blocks(torch, launch, dense_gate, dense_gate_reference):
    """The top-tier launch's bases one at a time: a one-base launch has
    blocks of fewer rows, which straddle two 256-row P tiles; where one of
    the two tiles is live for a Q chunk and the other dead, the dead tile's
    rows must add no match and no count. The two bases with the most such
    (block, Q chunk) pairs are checked kernel == plain; at least one pair
    is required."""
    from model_matching_tpu_torch.ops.dense_gate import P_TILE, gate_rows

    args, kw = launch
    b, p = args[2].shape
    dev = args[2].device
    rows, rows_launch = gate_rows(1, p, dev), gate_rows(b, p, dev)
    r0 = torch.arange(0, p, rows, device=dev)
    t0, t1 = r0 // P_TILE, torch.clamp(r0 + rows - 1, max=p - 1) // P_TILE
    live = kw["live"]
    mixed = ((live[:, t0] != live[:, t1]) & (t0 != t1)[None, :, None]).sum((1, 2))
    pick = torch.argsort(mixed, descending=True, stable=True)[:2].tolist()
    if int(mixed[pick[0]]) == 0:
        raise AssertionError(f"no block of {rows} rows straddles a live and a dead P tile")
    for k in pick:
        one_args, one_kw = _slice_bases(args, kw, [k])
        _gate_equal(torch, dense_gate, dense_gate_reference, one_args, one_kw,
                    f"packed top tier, base {k} alone ({rows}-row blocks)")
    print(f"packed top tier, one base a launch: {rows}-row blocks (the {b}-base launch "
          f"ran {rows_launch}-row blocks); bases {pick} have "
          f"{[int(mixed[k]) for k in pick]} (block, Q chunk) pairs across a live and a dead "
          f"P tile; kernel == plain on each")
    return {"rows_one_base": rows, "rows_launch": rows_launch,
            "bases": pick, "mixed_pairs": [int(mixed[k]) for k in pick]}


def _packed_small(torch, dev, model, cfg, root, obj):
    """The card against the CPU on the whole instance run at 160x120, the
    caps of tests/test_torch_presets.py (8,192 pairs per bin, banded: two Q
    chunks of 4,352), 16 bases: bases, masks, decayed prior, congruent
    sets and selection_shortfall equal, the same best index, LCP within
    1e-5, pose within 1e-4."""
    import dataclasses

    from model_matching_tpu_torch import congruent
    from model_matching_tpu_torch import estimator as est_mod
    from model_matching_tpu_torch.scene import load_scene
    from model_matching_tpu_torch.synthetic import write_synthetic_packed_scene

    small_dir, small_cfg, _boxes = write_synthetic_packed_scene(
        os.path.join(root, "small"), obj, scale=0.25)
    small_cfg = dataclasses.replace(small_cfg, number_of_bases=16, max_pairs_per_bin=8192,
                                    congruent_band_min_cap=8192)
    maps = os.path.join(small_dir, "probability_maps")
    paths = [os.path.join(small_dir, "rgb.png"), os.path.join(small_dir, "depth.png"),
             os.path.join(maps, f"{obj}.png"), os.path.join(maps, "edge.png")]
    real_s, real_c = est_mod._phase_sample_instance, est_mod._run_congruent
    res = {}
    got = []

    def recorded(real):
        def call(*a, **kw):
            got.append(real(*a, **kw))
            return got[-1]
        return call

    for name, d in (("cpu", "cpu"), ("cuda", dev)):
        got.clear()
        est_mod._phase_sample_instance = recorded(real_s)
        est_mod._run_congruent = recorded(real_c)
        try:
            t0 = time.perf_counter()
            out = est_mod.StocsEstimator(model.to(d), load_scene(*paths, small_cfg, device=d),
                                         small_cfg).run(verbose=False)
            wall = time.perf_counter() - t0
        finally:
            est_mod._phase_sample_instance, est_mod._run_congruent = real_s, real_c
        res[name] = (*got, out, wall)
    (i_c, s_c, r_c, t_c), (i_g, s_g, r_g, _t_g) = res["cpu"], res["cuda"]
    same = (all(torch.equal(getattr(i_c, f), getattr(i_g, f).cpu()) for f in i_c._fields)
            and all(torch.equal(getattr(s_c, f), getattr(s_g, f).cpu()) for f in s_c._fields))
    sh = [int(congruent.selection_shortfall(s, small_cfg)) for s in (s_c, s_g)]
    pose_err = float(abs(r_c.best_world_transform - r_g.best_world_transform).max())
    print(f"packed 160x120, 16 bases, 8,192 pairs per bin: card against CPU: bases, masks, "
          f"prior, congruent sets equal: {same}; selection_shortfall {sh}; pair_count_max "
          f"{int(s_c.pair_counts.max())}; best_index cpu {r_c.best_index} cuda "
          f"{r_g.best_index}; best_lcp cpu {r_c.best_lcp:.7f} cuda {r_g.best_lcp:.7f}; "
          f"pose max abs diff {pose_err:.2e}; CPU run {t_c:.3f} s (load_scene included)")
    if (not same or sh[0] != sh[1] or r_c.best_index != r_g.best_index
            or r_c.best_index < 0 or abs(r_c.best_lcp - r_g.best_lcp) > 1e-5
            or pose_err > 1e-4):
        raise AssertionError("the packed instance path on the card disagrees with the CPU")
    return {"same": same, "selection_shortfall": sh[1], "best_index": r_g.best_index}


class _phase_clock:
    """Wall time of the estimator's sampling, congruent, fit and scoring
    steps (each ended by a synchronize), by wrapping the names the sweep
    calls."""

    _NAMES = ("_phase_sample_instance", "_run_congruent", "_phase_fit", "_phase_score")

    def __init__(self, torch):
        from model_matching_tpu_torch import estimator as est_mod

        self._mod, self._real = est_mod, {n: getattr(est_mod, n) for n in self._NAMES}
        self.seconds = dict.fromkeys(self._NAMES, 0.0)

        def timed(name):
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = self._real[name](*a, **kw)
                torch.cuda.synchronize()
                self.seconds[name] += time.perf_counter() - t0
                return out
            return call

        for n in self._NAMES:
            setattr(est_mod, n, timed(n))

    def stop(self):
        for n, f in self._real.items():
            setattr(self._mod, n, f)


def _packed_sweep(torch, dev, dense_gate, dense_gate_reference, row_gather, packed):
    """One 2,048-base chunk of --sweep 2048 --sweep-chunk 2048 --cluster on
    the packed scene: bases/s, the steps' ms a base, the launches checked."""
    import numpy as np

    from model_matching_tpu_torch import cli

    root, scene_dir, obj = packed["root"], packed["scene_dir"], packed["obj"]
    pose_file = os.path.join(scene_dir, f"best_pose_candidate_{obj}.txt")
    os.remove(pose_file)
    log = _log_events()
    gathers, gates = _record_gathers(), _record_gates()
    clock = _phase_clock(torch)
    k_before = _kernel_launches()
    try:
        t0 = time.perf_counter()
        rc = cli.main(["stocs-single", scene_dir, obj, "--repo-path", root, "--preset",
                       "packed", "--sweep", "2048", "--sweep-chunk", "2048", "--cluster"])
        t_cmd = time.perf_counter() - t0
    finally:
        clock.stop()
        gathers.stop()
        gates.stop()
        log.stop()
    counts = _kernel_launches(k_before)
    if rc != 0 or not os.path.exists(pose_file):
        raise AssertionError("the packed sweep failed")
    for w in log.warnings:
        print(f"warning logged: {w}")
    ev = log.last("stocs_sweep")
    per_base = {k.lstrip("_").replace("phase_", ""): v / 2048 * 1e3
                for k, v in clock.seconds.items()}
    print(f"packed sweep, one 2048-base chunk ({_gpu_name_and_limit()}): command "
          f"{t_cmd:.3f} s; {ev['bases_per_sec']:.1f} bases/s, "
          f"{ev['hypotheses_per_sec']:.1f} hypotheses/s over {ev['seconds']:.3f} s "
          f"({ev['hypotheses']} hypotheses, best_lcp {ev['best_lcp']:.6f}, "
          f"{ev['clusters']} clusters, pair_count_max {ev['pair_count_max']}); ms a base "
          f"(each step ended by a synchronize): "
          + json.dumps({k: round(v, 4) for k, v in per_base.items()})
          + f"; launches {json.dumps(counts)}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"the packed sweep missed a kernel: {counts}")
    _on_a_box(np, np.loadtxt(pose_file).reshape(3, 4), packed["boxes"], "packed sweep")
    gate_rows = _check_recorded_gates(torch, gates.calls, dense_gate,
                                      dense_gate_reference, "packed sweep chunk")
    gather_rows, gather_err = _check_gathers(
        torch, _recorded_gather_cases(gathers.calls), time_repeats=False)
    gates.calls.clear()
    gathers.calls.clear()
    return dict(counts, bases_per_sec=ev["bases_per_sec"],
                hypotheses_per_sec=ev["hypotheses_per_sec"], ms_per_base=per_base,
                gates=gate_rows, gate_max_abs_err=gate_rows["max_abs_err"],
                gathers=gather_rows, gather_max_abs_err=gather_err)


def _packed_block_mode(torch, dev, dense_gate, dense_gate_reference, row_gather, packed):
    """instance_block_size=8 on the packed scene: an estimator run on the
    card, its dense-gate launches and row gathers held to their plain
    versions, its decayed prior equal to the CPU's bit for bit (the decay's
    power is fmath.pow), and sampling's ms and operators dispatched a base
    beside block size 1."""
    import dataclasses

    import numpy as np

    from model_matching_tpu_torch import estimator as est_mod
    from model_matching_tpu_torch import rng
    from model_matching_tpu_torch.model import load_model_pack
    from model_matching_tpu_torch.ops import fmath
    from model_matching_tpu_torch.scene import load_scene

    cfg = packed["cfg"]
    cfg8 = dataclasses.replace(cfg, instance_block_size=8)
    scene_dir, obj = packed["scene_dir"], packed["obj"]
    paths = [os.path.join(scene_dir, n) for n in (
        "rgb.png", "depth.png", f"probability_maps/{obj}.png", "probability_maps/edge.png")]
    scene = load_scene(*paths, cfg8, device=dev)
    model = load_model_pack(*packed["model_files"], cfg8.max_model_points, device=dev)
    exps, real_pow = [], fmath.pow

    def power(x, y):
        exps.append(y.max())
        return real_pow(x, y)

    fmath.pow = power
    gathers, gates = _record_gathers(scene), _record_gates()
    k_before = _kernel_launches()
    try:
        est = est_mod.StocsEstimator(model, scene, cfg8)
        t0 = time.perf_counter()
        res = est.run(verbose=False)
        wall = time.perf_counter() - t0
    finally:
        fmath.pow = real_pow
        gathers.stop()
        gates.stop()
    counts = _kernel_launches(k_before)
    top_exp = float(torch.stack(exps).max()) if exps else 0.0
    if min(counts.values()) <= 0 or top_exp < 2:
        raise AssertionError(f"block mode missed a kernel or never decayed twice in a "
                             f"block: {counts}, largest exponent {top_exp}")
    if res.best_index < 0:
        raise AssertionError("block mode found no pose")
    _on_a_box(np, res.best_world_transform[:3], packed["boxes"], "block mode")
    gate_rows = _check_recorded_gates(torch, gates.calls, dense_gate,
                                      dense_gate_reference, "packed block 8")
    gather_rows, gather_err = _check_gathers(
        torch, _recorded_gather_cases(gathers.calls), time_repeats=False)
    gates.calls.clear()
    gathers.calls.clear()
    k_sample = rng.split(rng.PRNGKey(cfg8.seed))[0]
    t0 = time.perf_counter()
    inst_cpu = est_mod._phase_sample_instance(
        k_sample, model.table.to("cpu"), scene.to("cpu"), scene.class_prob.cpu(), cfg8,
        cfg8.number_of_bases)
    t_cpu = time.perf_counter() - t0
    if not (torch.equal(est.class_prob.cpu(), inst_cpu.class_prob)
            and torch.equal(est.seg_masks.cpu(), inst_cpu.seg_masks)):
        raise AssertionError("block mode: the decayed prior or the masks differ card "
                             "against CPU")

    def sampling(block, n):
        c = dataclasses.replace(cfg, instance_block_size=block)
        return lambda: est_mod._phase_sample_instance(
            k_sample, model.table, scene, scene.class_prob, c, n)

    out = {}
    for block in (1, 8):
        n = cfg.number_of_bases
        secs, _ = _median_wall(torch, sampling(block, n))
        ops = _launches(torch, sampling(block, 16)) / 16
        out[block] = {"ms_per_base": secs / n * 1e3, "ops_dispatched_per_base": ops}
    print(f"block mode ({_gpu_name_and_limit()}): instance_block_size=8 estimator run "
          f"{wall * 1e3:.3f} ms (first), best_lcp {res.best_lcp:.6f}; launches "
          f"{json.dumps(counts)}; decay exponents up to {top_exp:g}; decayed prior and "
          f"masks equal to the CPU's bit for bit (CPU sampler {t_cpu:.3f} s); sampling, "
          f"warm median of 3, {cfg.number_of_bases} bases: block 1 "
          f"{out[1]['ms_per_base']:.4f} ms a base, {out[1]['ops_dispatched_per_base']:.1f} "
          f"operators dispatched from the host a base (its graph replays dispatch none); "
          f"block 8 {out[8]['ms_per_base']:.4f} ms a base, "
          f"{out[8]['ops_dispatched_per_base']:.1f} a base (a kernel each)")
    return dict(counts, wall_ms=wall * 1e3, largest_exponent=top_exp, sampling=out,
                gates=gate_rows, gate_max_abs_err=gate_rows["max_abs_err"],
                gathers=gather_rows, gather_max_abs_err=gather_err)


def _linemod_phase(torch, dev, dense_gate, dense_gate_reference, row_gather):
    """The linemod preset on mm-unit files at full width."""
    import numpy as np

    from model_matching_tpu_torch import cli
    from model_matching_tpu_torch.config import get_preset
    from model_matching_tpu_torch.io import ply
    from model_matching_tpu_torch.scene import load_scene
    from model_matching_tpu_torch.synthetic import write_synthetic_scene

    root = os.path.join(_ROOT, "build", "chip_smoke_linemod")
    shutil.rmtree(root, ignore_errors=True)
    obj = "lm_shell"
    scene_dir, cfg, gt = write_synthetic_scene(root, obj, preset="linemod")
    if cfg != get_preset("linemod").match:
        raise AssertionError("the scene was not written at the linemod preset's camera")
    src = os.path.join(root, "models", obj, "textured_vertices.ply")
    if not np.abs(ply.read_ply_cloud(src)[0]).max() > 10.0:
        raise AssertionError("the linemod source cloud is not in millimetres")
    t0 = time.perf_counter()
    if cli.main(["model-preprocess", obj, "--repo-path", root, "--preset", "linemod"]) != 0:
        raise AssertionError("model-preprocess --preset linemod failed")
    t_pre = time.perf_counter() - t0
    gathers, gates = _record_gathers(), _record_gates()
    k_before = _kernel_launches()
    try:
        t0 = time.perf_counter()
        rc = cli.main(["stocs-single", scene_dir, obj, "--repo-path", root,
                       "--preset", "linemod"])
        t_single = time.perf_counter() - t0
    finally:
        gathers.stop()
        gates.stop()
    counts = _kernel_launches(k_before)
    if rc != 0 or min(counts.values()) <= 0:
        raise AssertionError(f"stocs-single --preset linemod failed or missed a kernel: "
                             f"{counts}")
    paths = [os.path.join(scene_dir, n) for n in
             ("rgb.png", "depth.png", f"probability_maps/{obj}.png")]
    gpu = load_scene(*paths, None, cfg, device=dev)
    cpu = load_scene(*paths, None, cfg, device="cpu")
    for f in ("valid", "pos", "normal", "class_prob"):
        if not torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)):
            raise AssertionError(f"linemod: load_scene on the card differs from the CPU in {f}")
    model_ply = os.path.join(root, "models", obj, "model_search.ply")
    pose_file = os.path.join(scene_dir, f"best_pose_candidate_{obj}.txt")
    _pose_file_on_scene(torch, dev, np, pose_file, model_ply, gpu, cfg)
    gt_file = os.path.join(root, "gt_pose.txt")
    with open(gt_file, "w") as f:
        f.write(" ".join(f"{gt[r, c]:.9g}" for r in range(3) for c in range(4)) + "\n")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = cli.main(["eval", pose_file, gt_file, "--model", src, "--model-scale", "0.001"])
    report = json.loads(text.getvalue())
    if rc != 0 or report["adds_pass_rate"] != 1.0:
        raise AssertionError(f"linemod: ADD-S does not pass: {report}")
    gate_rows = _check_recorded_gates(torch, gates.calls, dense_gate,
                                      dense_gate_reference, "linemod")
    gather_rows, gather_err = _check_gathers(
        torch, _recorded_gather_cases(gathers.calls), time_repeats=False)
    gates.calls.clear()
    gathers.calls.clear()
    print(f"linemod ({_gpu_name_and_limit()}): model-preprocess {t_pre:.3f} s (mm source, "
          f"10 mm voxels), stocs-single {t_single:.3f} s, |S| = {int(gpu.count())}; ingest "
          f"card == CPU bit for bit; ADD-S {report['adds_mean']:.6f} m against a threshold "
          f"of {report['threshold']:.6f} m (10% of the diameter); launches "
          f"{json.dumps(counts)}")
    return dict(counts, adds=report["adds_mean"], threshold=report["threshold"],
                gates=gate_rows, gate_max_abs_err=gate_rows["max_abs_err"],
                gathers=gather_rows, gather_max_abs_err=gather_err)


if __name__ == "__main__":
    sys.exit(main())
