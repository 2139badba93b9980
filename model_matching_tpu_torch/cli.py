"""Command-line interface, on the card.

    python -m model_matching_tpu_torch.cli model-preprocess <object> [options]
    python -m model_matching_tpu_torch.cli stocs-single <scene_path> <object> [options]
    python -m model_matching_tpu_torch.cli stocs-batch <scene_path> <obj1,obj2,...> [options]
    python -m model_matching_tpu_torch.cli stocs-multi <scene_path> <obj1,obj2,...> [options]
    python -m model_matching_tpu_torch.cli serve [options]      (requests on stdin)
    python -m model_matching_tpu_torch.cli eval <est> <gt> --model <ply> [options]

Counterpart of ``model_matching_tpu/cli.py``, with its flags, messages,
artifact names and formats: models/<object>/model_search.ply +
ppf_table.npz, <scene>/best_pose_candidate_<object>.txt (12 floats,
row-major 3x4, one line) and <scene>/dbg/{sampled_scene,best_pose,
scene}.ply. A scene with probability_maps/edge.png takes the instance path
and also writes dbg/seg_mask_<n>.png. `--cluster` writes
clustered_poses_<object>.txt (a pose and its LCP a line), `--heatmap`
dbg/probability_heatmap.png and dbg/overlay_<object>.png, `--sweep N` runs
the chunked sweep (`--sweep-chunk`, `--sweep-checkpoint`,
`--sweep-checkpoint-every`, `--sweep-stop-after`) and writes only the pose
file, as the JAX package's command does: `--cluster`, `--heatmap` and
`--profile` do not apply to it. With more than one rank in sight (several
cards, times the world size under torch.distributed) the sweep shards over
them (parallel/sharding.py), its chunk rounded up to a multiple of the rank
count. `--profile DIR` writes a torch.profiler Chrome trace of the run
under DIR, with the port's spans (utils/trace.py) as `mm.<span>` ranges
over the kernels. `stocs-batch` runs `stocs-single` once per
object; `stocs-multi` matches every object against one shared scene
(multi.py) and writes each object's pose file; `serve` answers
'<scene_path> <object>' lines with 'OK <12 floats> <lcp>' or 'ERR
<reason>', and logs a `serve_request` event a request (its seconds,
`phases_ms`: the milliseconds of its top-level spans and their children by
name, its `host_reads`, `k1_launches` and `k2_launches`, and whether it
loaded a model, loaded the kernels or built them); `eval` prints the ADD /
ADD-S JSON document of pose files
against ground truth (pose files, or a BOP scene_gt.json). `--device`
picks the device (default cuda; without a card the commands fail unless
given `--device cpu`). `main(argv)` runs in-process; it first joins a
torch.distributed group when one is configured (torchrun's environment,
parallel/sharding.init_distributed).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import time

import numpy as np


def _add_common(p):
    p.add_argument("--preset", default="ycb", help="ycb | linemod | packed")
    p.add_argument("--repo-path", default=".",
                   help="root containing models/<object>/ (default: the "
                        "current directory)")
    p.add_argument("--output-root", default=None,
                   help="writable root for artifacts (defaults to repo path; "
                        "use when the repo is read-only)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")


def _guard_writable(path: str) -> None:
    """Refuse, with the flag that fixes it, to write artifacts into a tree
    this process cannot write (a read-only checkout of the reference): the
    tools write next to their inputs by default."""
    probe = os.path.realpath(path)
    while not os.path.exists(probe):
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    if not os.access(probe, os.W_OK):
        raise SystemExit(
            f"error: refusing to write artifacts under the read-only tree "
            f"{probe}; pass --output-root <writable dir>"
        )


def _check_scene_inputs(scene_path, objects):
    """Friendly error instead of a loader traceback when the scene is
    missing rgb/depth/probability-map files."""
    paths = [
        os.path.join(scene_path, "rgb.png"),
        os.path.join(scene_path, "depth.png"),
    ] + [
        os.path.join(scene_path, "probability_maps", f"{o}.png")
        for o in objects
    ]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print("error: missing scene inputs:\n  " + "\n  ".join(missing))
    return not missing


def _model_dirs(args, object_name):
    src_root = os.path.join(args.repo_path, "models", object_name)
    out_root = os.path.join(
        args.output_root or args.repo_path, "models", object_name
    )
    return src_root, out_root


def _scene_out(args):
    """Where a scene's artifacts go: <output-root>/<scene name>, or the
    scene directory itself."""
    if args.output_root:
        return os.path.join(args.output_root, os.path.basename(args.scene_path.rstrip("/")))
    return args.scene_path


def _device(args):
    from .utils.device import require

    try:
        return require(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"error: {e}") from None


def cmd_model_preprocess(argv):
    from .config import get_preset
    from .preprocess import preprocess_model

    p = argparse.ArgumentParser(prog="model-preprocess")
    p.add_argument("object")
    _add_common(p)
    p.add_argument("--voxel-size", type=float, default=None)
    p.add_argument("--normal-radius", type=float, default=None)
    p.add_argument("--model-scale", type=float, default=None)
    args = p.parse_args(argv)
    dev = _device(args)

    pre = get_preset(args.preset).preprocess
    overrides = {
        k: v
        for k, v in (
            ("voxel_size", args.voxel_size),
            ("normal_radius", args.normal_radius),
            ("model_scale", args.model_scale),
        )
        if v is not None
    }
    pre = dataclasses.replace(pre, **overrides)

    src_root, out_root = _model_dirs(args, args.object)
    src = os.path.join(src_root, "textured_vertices.ply")
    if not os.path.exists(src):
        print(f"error: model source {src} not found")
        return 1
    dst_model = os.path.join(out_root, "model_search.ply")
    dst_table = os.path.join(out_root, "ppf_table.npz")
    _guard_writable(out_root)
    os.makedirs(out_root, exist_ok=True)
    for f in (dst_model, dst_table):
        if os.path.exists(f):
            os.remove(f)

    n, _maxd = preprocess_model(src, dst_model, dst_table, pre, device=dev)
    print(f"wrote {dst_model} ({n} points) and {dst_table}")
    return 0


def _pose_row(t):
    return " ".join(f"{t[i, j]:g}" for i in range(3) for j in range(4))


def _write_pose(path, t):
    with open(path, "w") as f:
        f.write(_pose_row(t) + "\n")


def _write_clusters(path, transforms, lcps):
    with open(path, "w") as f:
        for t, s in zip(transforms, lcps):
            f.write(f"{_pose_row(t)} {s:g}\n")
    print(f"wrote {path} ({len(transforms)} clusters)")


def _write_heatmap(dbg, scene_path, object_name, scene, est, model, cfg, live,
                   world_transform):
    """dbg/probability_heatmap.png of the estimator's current (possibly
    decayed) prior, and the overlay of `world_transform` when there is
    one."""
    from . import viz
    from .estimator import _to_host

    pix, prob, mpos, mvalid, mc = _to_host(
        scene.pixel, est.class_prob, model.pos, model.valid, model.centroid)
    viz.visualize_heatmap(
        pix[live].astype(np.int64), prob[live].astype(np.float32), [],
        os.path.join(dbg, "probability_heatmap.png"),
        cfg.image_width, cfg.image_height,
    )
    if world_transform is not None:
        mp = (mpos[mvalid.astype(bool)] + mc).astype(np.float32)
        viz.overlay_pose(
            os.path.join(scene_path, "rgb.png"), mp, world_transform,
            *cfg.camera.as_tuple(),
            os.path.join(dbg, f"overlay_{object_name}.png"),
        )


def _profiled(out_dir, dev, fn):
    """fn() under torch.profiler when `out_dir` is given: CUDA activity on
    the card, CPU activity on the CPU; the Chrome trace is written under
    `out_dir` (also when fn raises)."""
    if out_dir is None:
        return fn()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .utils import trace

    trace.annotate(True)

    act = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
    prof = profile(activities=[act])
    try:
        with prof:
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return out
    finally:
        trace.annotate(False)
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            out_dir, f"stocs_single.{os.getpid()}.{time.time_ns()}.pt.trace.json"))
        print(f"profiler trace written to {out_dir}")


def _sweep_devices(dev):
    """The ranks of this process that a --sweep may shard over
    (sharding.process_devices: the process's own card under torchrun,
    every visible card otherwise, or the one CPU)."""
    from .parallel import sharding

    return sharding.process_devices(dev)


def _sweep_mesh(dev, scene):
    """The mesh of a --sweep, or None for the one-device sweep: this
    process's ranks times the processes of a torch.distributed group, when
    that is more than one. An edge-mapped scene under several processes
    keeps the one-device sweep, as the JAX package's command does."""
    from .parallel import sharding

    devices = _sweep_devices(dev)
    world = sharding.process_count()
    if scene.has_edge and world > 1:
        print("note: edge-mapped scene — instance-mode sweeps shard "
              "over ICI only (single process); multi-host sharding "
              "applies to class-path scenes")
        return None
    if len(devices) * world <= 1:
        return None
    return sharding.make_mesh(devices)


def cmd_stocs_single(argv):
    import torch

    from .config import get_preset
    from .estimator import StocsEstimator, _to_host
    from .io import ply
    from .model import load_model_pack
    from .scene import load_scene
    from .utils import trace

    p = argparse.ArgumentParser(prog="stocs-single")
    p.add_argument("scene_path")
    p.add_argument("object")
    _add_common(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--number-of-bases", type=int, default=None)
    p.add_argument("--no-coarse-to-fine", action="store_true",
                   help="score every hypothesis with the full model")
    p.add_argument("--no-refine", action="store_true",
                   help="skip the point-to-plane ICP polish of the winner")
    p.add_argument("--cluster", action="store_true",
                   help="also write clustered_poses_<object>.txt")
    p.add_argument("--heatmap", action="store_true",
                   help="write probability heatmap + pose overlay PNGs")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run to DIR")
    p.add_argument("--sweep", type=int, default=None, metavar="TOTAL_BASES",
                   help="large hypothesis sweep: process TOTAL_BASES in "
                        "chunks (StocsEstimator.run_sweep, or "
                        "parallel.sharding.run_sweep_sharded over several "
                        "ranks) instead of one number-of-bases run; writes "
                        "only the pose file")
    p.add_argument("--sweep-chunk", type=int, default=2048, metavar="BASES",
                   help="bases per sweep chunk (default 2048)")
    p.add_argument("--sweep-checkpoint", default=None, metavar="PATH",
                   help="persist sweep state to PATH every "
                        "--sweep-checkpoint-every chunks; re-running with "
                        "the same arguments resumes (bit-identical to an "
                        "uninterrupted sweep); removed on completion")
    p.add_argument("--sweep-checkpoint-every", type=int, default=8,
                   metavar="CHUNKS")
    p.add_argument("--sweep-stop-after", type=int, default=None,
                   metavar="CHUNKS",
                   help="process at most CHUNKS chunks this invocation, "
                        "checkpoint, and exit (time-sliced operation; "
                        "requires --sweep-checkpoint)")
    args = p.parse_args(argv)

    if args.sweep_stop_after and not args.sweep_checkpoint:
        print("error: --sweep-stop-after requires --sweep-checkpoint "
              "(the remaining chunks must be resumable)")
        return 1
    dev = _device(args)

    cfg = get_preset(args.preset).match
    if args.number_of_bases is not None:
        cfg = dataclasses.replace(cfg, number_of_bases=args.number_of_bases)
    cfg = dataclasses.replace(
        cfg, seed=args.seed, refine_best_pose=not args.no_refine
    )

    _src_root, model_root = _model_dirs(args, args.object)
    model_ply = os.path.join(model_root, "model_search.ply")
    table_path = os.path.join(model_root, "ppf_table.npz")

    scene_out = _scene_out(args)
    _guard_writable(scene_out)
    dbg = os.path.join(scene_out, "dbg")
    shutil.rmtree(dbg, ignore_errors=True)
    os.makedirs(dbg, exist_ok=True)

    if not os.path.exists(model_ply):
        print(f"error: {model_ply} not found — run "
              f"'model-preprocess {args.object}' first")
        return 1
    print("############# LOADING OBJECT MAPS ################")
    model = load_model_pack(model_ply, table_path, cfg.max_model_points, device=dev)
    trace.count("host_reads")
    print(f"|M| = {int(model.count())}, pairs = {model.table.num_pairs}")
    print("############# LOADING OBJECT COMPLETE ################")

    if not _check_scene_inputs(args.scene_path, [args.object]):
        return 1
    edge_path = os.path.join(args.scene_path, "probability_maps", "edge.png")
    scene = load_scene(
        os.path.join(args.scene_path, "rgb.png"),
        os.path.join(args.scene_path, "depth.png"),
        os.path.join(args.scene_path, "probability_maps", f"{args.object}.png"),
        edge_path if os.path.exists(edge_path) else None,
        cfg, device=dev,
    )
    # one transfer for the debug artifacts
    s_pos, s_nrm, s_rgb, s_valid, s_cen = _to_host(
        scene.pos, scene.normal, scene.rgb, scene.valid, scene.centroid)
    live = s_valid.astype(bool)
    print(f"|S|: {int(live.sum())}")
    ply.write_ply(
        os.path.join(dbg, "sampled_scene.ply"),
        (s_pos[live] + s_cen).astype(np.float32), s_nrm[live], s_rgb[live],
    )

    print(f"############# RUNNING STOCS for Scene: {args.scene_path}, "
          f"Object: {args.object} ##############")
    est = StocsEstimator(model, scene, cfg)

    if args.sweep:
        # the JAX package's command: the pose file (or the stop message) and
        # nothing else; --cluster, --heatmap and --profile do not apply
        sweep_kw = dict(checkpoint_path=args.sweep_checkpoint,
                        checkpoint_every=args.sweep_checkpoint_every,
                        stop_after_chunks=args.sweep_stop_after)
        mesh = _sweep_mesh(dev, scene)
        if mesh is not None:
            from .parallel.sharding import run_sweep_sharded

            # chunks split evenly over the ranks: round up to their count
            chunk = -(-args.sweep_chunk // mesh.size) * mesh.size
            best_lcp, best_w, _ct, _cs, stats = run_sweep_sharded(
                mesh, model, scene, cfg, args.sweep, chunk=chunk, **sweep_kw)
        else:
            best_lcp, best_w, _ct, _cs, stats = est.run_sweep(
                args.sweep, chunk=args.sweep_chunk, **sweep_kw)
        if not stats.get("completed", True):
            print(f"sweep: stopped after chunk {stats['next_chunk']} — "
                  f"checkpoint at {args.sweep_checkpoint}; re-run the same "
                  f"command to resume")
            return 0
        out_file = os.path.join(scene_out, f"best_pose_candidate_{args.object}.txt")
        os.makedirs(scene_out, exist_ok=True)
        _write_pose(out_file, best_w)
        where = (torch.device("cuda", torch.cuda.current_device())
                 if dev.type == "cuda" else dev)
        print(f"wrote {out_file} (sweep best lcp {best_lcp:.4f}; "
              f"{stats.get('devices', 1)} ranks, this process on {where})")
        return 0

    result = _profiled(args.profile, dev,
                       lambda: est.run(coarse_to_fine=not args.no_coarse_to_fine))

    if est.seg_masks is not None:
        # seg_mask_<n>.png debug artifacts, one per base that has a segment
        from .io.image import write_u8

        trace.count("host_reads")
        masks = est.seg_masks.cpu().numpy()
        for i in range(1, masks.shape[0]):
            if masks[i].any():
                write_u8(os.path.join(dbg, f"seg_mask_{i}.png"),
                         masks[i].astype(np.uint8) * 255)

    if result.best_index >= 0:
        out_file = os.path.join(scene_out, f"best_pose_candidate_{args.object}.txt")
        os.makedirs(scene_out, exist_ok=True)
        _write_pose(out_file, result.best_world_transform)
        print(f"wrote {out_file}")

        # the transformed model and the scene, both in the centered frame
        m_pos, m_valid = _to_host(model.pos, model.valid)
        mp = torch.from_numpy(m_pos[m_valid.astype(bool)].astype(np.float32))
        from .ops.geometry import transform_points

        moved = transform_points(torch.from_numpy(result.best_transform), mp).numpy()
        ply.write_ply(os.path.join(dbg, "best_pose.ply"), moved)
        ply.write_ply(
            os.path.join(dbg, "scene.ply"), s_pos[live], s_nrm[live], s_rgb[live],
        )
    else:
        print("no pose found")

    if args.heatmap:
        _write_heatmap(dbg, args.scene_path, args.object, scene, est, model, cfg,
                       live, result.best_world_transform
                       if result.best_index >= 0 else None)

    if args.cluster and result.best_index >= 0:
        ctrs, clcp = est.cluster_poses(result)
        _write_clusters(
            os.path.join(scene_out, f"clustered_poses_{args.object}.txt"),
            ctrs, clcp)

    for phase, secs in result.timings.items():
        print(f"  {phase}: {secs*1e3:.1f} ms")
    print(f"  hypotheses/sec: {result.stats['hypotheses_per_sec']:.3g}")
    return 0


def cmd_stocs_batch(argv):
    """Match several objects against one scene in one process: stocs-single
    once per object, timed. The first object pays for loading the kernel
    library (and building it in a fresh checkout); the later ones reuse it.
    Exits with the first failing object's code."""
    p = argparse.ArgumentParser(prog="stocs-batch")
    p.add_argument("scene_path")
    p.add_argument("objects", help="comma-separated object names")
    _add_common(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--number-of-bases", type=int, default=None)
    args = p.parse_args(argv)

    objects = [o for o in args.objects.split(",") if o]
    rc = 0
    for i, obj in enumerate(objects):
        t0 = time.perf_counter()
        sub = [args.scene_path, obj, "--preset", args.preset,
               "--repo-path", args.repo_path, "--seed", str(args.seed),
               "--device", args.device]
        if args.output_root:
            sub += ["--output-root", args.output_root]
        if args.number_of_bases is not None:
            sub += ["--number-of-bases", str(args.number_of_bases)]
        r = cmd_stocs_single(sub)
        rc = rc or r
        secs = time.perf_counter() - t0
        print(f"[batch] {obj}: {secs:.1f}s" + (" (first object)" if i == 0 else ""))
    return rc


def cmd_stocs_multi(argv):
    """All objects against one scene: one shared scene geometry, per-object
    probability vectors (multi.py)."""
    from .config import get_preset
    from .model import load_model_pack
    from .multi import match_all_objects
    from .scene import load_scene_multi

    p = argparse.ArgumentParser(prog="stocs-multi")
    p.add_argument("scene_path")
    p.add_argument("objects", help="comma-separated object names")
    _add_common(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--number-of-bases", type=int, default=None)
    args = p.parse_args(argv)
    dev = _device(args)

    cfg = get_preset(args.preset).match
    if args.number_of_bases is not None:
        cfg = dataclasses.replace(cfg, number_of_bases=args.number_of_bases)

    objects = [o for o in args.objects.split(",") if o]
    if not _check_scene_inputs(args.scene_path, objects):
        return 1
    for obj in objects:
        _s, root = _model_dirs(args, obj)
        if not os.path.exists(os.path.join(root, "model_search.ply")):
            print(f"error: {root}/model_search.ply not found — run "
                  f"'model-preprocess {obj}' first")
            return 1
    models = []
    for obj in objects:
        _s, root = _model_dirs(args, obj)
        models.append(load_model_pack(
            os.path.join(root, "model_search.ply"),
            os.path.join(root, "ppf_table.npz"),
            cfg.max_model_points, standardize=True, device=dev,
        ))
    edge_path = os.path.join(args.scene_path, "probability_maps", "edge.png")
    scene, probs = load_scene_multi(
        os.path.join(args.scene_path, "rgb.png"),
        os.path.join(args.scene_path, "depth.png"),
        [os.path.join(args.scene_path, "probability_maps", f"{o}.png")
         for o in objects],
        edge_path if os.path.exists(edge_path) else None, cfg, device=dev,
    )
    if scene.has_edge:
        print("edge-mapped scene: instance path (per-object sequential "
              "dispersion decay; fused phases 2-4)")
    best, poses, nhyp = match_all_objects(models, scene, probs, cfg, seed=args.seed)
    out_root = _scene_out(args)
    _guard_writable(out_root)
    os.makedirs(out_root, exist_ok=True)
    for o, obj in enumerate(objects):
        lcp = float(best[o])
        if lcp <= 0.0:
            # no hypothesis scored above 0: the pose is arbitrary, nothing
            # is written (as stocs-single)
            print(f"{obj}: no pose found (0 scoring hypotheses of {int(nhyp[o])})")
            continue
        path = os.path.join(out_root, f"best_pose_candidate_{obj}.txt")
        _write_pose(path, poses[o])
        print(f"{obj}: lcp={lcp:.4f} hypotheses={int(nhyp[o])} -> {path}")
    return 0


def cmd_serve(argv):
    """Long-running estimation service: requests stream on stdin as
    '<scene_path> <object>' lines, each answered by one line 'OK <12 pose
    floats> <lcp>' or 'ERR <reason>'; 'quit' or 'exit' ends it, and an
    exception in a request is answered with ERR and does not end the loop.
    What it amortizes across requests is the process start, the loading
    (and in a fresh checkout the nvcc build) of the CUDA kernels
    (ops/_build.py) and the model packs, cached per object; there is no
    compilation to share. The packs load with standardize=True, padded to
    the JAX package's shared shape floors as its serve loads them, so an OK
    line carries the pose the estimator gives on a standardized pack (which
    may differ from the stocs-single file in the last digits). Each request
    logs a `serve_request` event with its seconds, the milliseconds of its
    top-level spans and their children (`phases_ms`), its host reads and
    K1 / K2 launches, and whether it loaded a model, loaded the kernels or
    built them (utils/trace.py)."""
    from .config import get_preset
    from .estimator import StocsEstimator
    from .model import load_model_pack
    from .scene import load_scene
    from .utils import trace
    from .utils.log import log_event

    tallied = ("host_reads", "k1.launches", "k2.launches", "kernels.loads",
               "kernels.builds")

    p = argparse.ArgumentParser(prog="serve")
    _add_common(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--number-of-bases", type=int, default=None)
    args = p.parse_args(argv)
    dev = _device(args)

    cfg = get_preset(args.preset).match
    if args.number_of_bases is not None:
        cfg = dataclasses.replace(cfg, number_of_bases=args.number_of_bases)
    cfg = dataclasses.replace(cfg, seed=args.seed)

    models = {}
    print("READY", flush=True)
    for line in sys.stdin:
        parts = line.split()
        if not parts:
            continue
        if parts[0] in ("quit", "exit"):
            break
        if len(parts) != 2:
            print("ERR usage: <scene_path> <object>", flush=True)
            continue
        scene_path, obj = parts
        t0 = time.perf_counter()
        before = {k: trace.total(k) for k in tallied}
        since = trace.mark()
        new_model = obj not in models
        answer = "ERR"
        with trace.request() as rid:
            try:
                if new_model:
                    _s, root = _model_dirs(args, obj)
                    models[obj] = load_model_pack(
                        os.path.join(root, "model_search.ply"),
                        os.path.join(root, "ppf_table.npz"),
                        cfg.max_model_points, standardize=True, device=dev,
                    )
                edge = os.path.join(scene_path, "probability_maps", "edge.png")
                scene = load_scene(
                    os.path.join(scene_path, "rgb.png"),
                    os.path.join(scene_path, "depth.png"),
                    os.path.join(scene_path, "probability_maps", f"{obj}.png"),
                    edge if os.path.exists(edge) else None,
                    cfg, device=dev,
                )
                result = StocsEstimator(models[obj], scene, cfg).run(verbose=False)
                if result.best_index < 0:
                    print("ERR no pose found", flush=True)
                else:
                    answer = "OK"
                    print(f"OK {_pose_row(result.best_world_transform)} "
                          f"{result.best_lcp:g}", flush=True)
            except Exception as e:  # answer and keep serving
                from .utils.log import get_logger

                get_logger().exception("serve: request %r failed", line.strip())
                print(f"ERR {type(e).__name__}: {e}", flush=True)
        n = {k: trace.total(k) - before[k] for k in tallied}
        mine = [e for e in trace.snapshot(since).entries if e.request == rid]
        log_event("serve_request", scene=scene_path, object=obj, answer=answer,
                  seconds=time.perf_counter() - t0,
                  phases_ms={k: round(v, 3) for k, v in trace.phases_ms(mine).items()},
                  host_reads=n["host_reads"], k1_launches=n["k1.launches"],
                  k2_launches=n["k2.launches"],
                  model_loaded=new_model and obj in models,
                  kernels_loaded=n["kernels.loads"] > 0,
                  kernels_built=n["kernels.builds"] > 0)
    return 0


def cmd_eval(argv):
    """Pose-accuracy evaluation: ADD / ADD-S / pass-rate of estimated pose
    file(s) against ground-truth pose file(s) over a model PLY, printed as
    one JSON document (the JAX package's keys); the metrics run on
    `--device`."""
    import json

    from . import eval as ev
    from .io import ply

    p = argparse.ArgumentParser(prog="eval")
    p.add_argument("est", help="estimated pose file (one pose per line, "
                               "12 or 16 floats) or directory of "
                               "best_pose_candidate_*.txt files")
    p.add_argument("gt", help="ground-truth pose file, a directory with "
                              "files named like the estimates, or a BOP "
                              "scene_gt.json (then pass --im-id/--obj-id)")
    p.add_argument("--im-id", type=int, default=None,
                   help="BOP image id inside scene_gt.json")
    p.add_argument("--obj-id", type=int, default=None,
                   help="BOP object id inside scene_gt.json (multiple GT "
                        "instances score each estimate against its "
                        "best-matching instance)")
    p.add_argument("--model", required=True,
                   help="model PLY the poses transform (model_search.ply "
                        "or textured_vertices.ply)")
    p.add_argument("--model-scale", type=float, default=1.0,
                   help="scale applied to model vertices (1/1000 for "
                        "mm-unit files, as in the linemod preset)")
    p.add_argument("--threshold-fraction", type=float, default=0.1,
                   help="pass if metric < fraction * model diameter")
    p.add_argument("--out", default=None, help="also write the JSON here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = _device(args)

    if not os.path.exists(args.model):
        print(f"error: model {args.model} not found")
        return 1
    mpos, _n, _c = ply.read_ply_cloud(args.model, scale=args.model_scale)

    bop_gt = None
    if args.gt.endswith(".json"):
        from .io import bop

        if args.im_id is None or args.obj_id is None:
            print("error: a scene_gt.json ground truth needs --im-id "
                  "and --obj-id")
            return 1
        try:
            bop_gt = bop.gt_poses(bop.load_scene_gt(args.gt), args.im_id, args.obj_id)
        except KeyError as e:
            print(f"error: {e}")
            return 1

    if os.path.isdir(args.est):
        names = sorted(
            f for f in os.listdir(args.est)
            if f.startswith("best_pose_candidate_") and f.endswith(".txt")
        )
        if not names:
            print(f"error: no best_pose_candidate_*.txt under {args.est}")
            return 1
        if bop_gt is not None:
            # one scene_gt.json serves every estimate file
            pairs = [(os.path.join(args.est, n), args.gt) for n in names]
        else:
            pairs = [(os.path.join(args.est, n), os.path.join(args.gt, n))
                     for n in names]
            missing = [g for _, g in pairs if not os.path.exists(g)]
            if missing:
                print("error: missing ground-truth files:\n  "
                      + "\n  ".join(missing))
                return 1
    else:
        pairs = [(args.est, args.gt)]

    dia = ev.model_diameter(mpos)
    per_file = {}
    for est_path, gt_path in pairs:
        per_file[os.path.basename(est_path)] = ev.evaluate_pose_files(
            est_path, gt_path, mpos,
            threshold_fraction=args.threshold_fraction, diameter=dia,
            gt_poses=bop_gt, device=dev,
        )
    all_add = [v for r in per_file.values() for v in r["add"]]
    all_adds = [v for r in per_file.values() for v in r["adds"]]
    thr = args.threshold_fraction * dia
    report = {
        "model": args.model,
        "model_diameter": dia,
        "threshold": thr,
        "num_poses": len(all_add),
        "add_mean": float(np.mean(all_add)),
        "adds_mean": float(np.mean(all_adds)),
        "add_pass_rate": float(np.mean([v < thr for v in all_add])),
        "adds_pass_rate": float(np.mean([v < thr for v in all_adds])),
        "files": per_file,
    }
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        _guard_writable(args.out)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


_COMMANDS = {
    "model-preprocess": cmd_model_preprocess,
    "stocs-single": cmd_stocs_single,
    "stocs-batch": cmd_stocs_batch,
    "stocs-multi": cmd_stocs_multi,
    "serve": cmd_serve,
    "eval": cmd_eval,
}


def main(argv=None):
    from .parallel.sharding import init_distributed

    # joins a torch.distributed group when torchrun's environment names
    # one; a no-op otherwise
    init_distributed()
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd in _COMMANDS:
        return _COMMANDS[cmd](rest)
    print(
        f"unknown command {cmd!r}; use model-preprocess, stocs-single, "
        "stocs-batch, stocs-multi, serve or eval"
    )
    return 2


if __name__ == "__main__":
    sys.exit(main())
