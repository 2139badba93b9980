"""Command-line interface: the reference's two entry points, on the card.

    python -m model_matching_tpu_torch.cli model-preprocess <object> [options]
    python -m model_matching_tpu_torch.cli stocs-single <scene_path> <object> [options]

Counterpart of ``model_matching_tpu/cli.py`` for these two commands, with
its flags, artifact names and formats: models/<object>/model_search.ply +
ppf_table.npz, <scene>/best_pose_candidate_<object>.txt (12 floats,
row-major 3x4, one line) and <scene>/dbg/{sampled_scene,best_pose,
scene}.ply. A scene with probability_maps/edge.png takes the instance path
and also writes dbg/seg_mask_<n>.png. `--cluster` writes
clustered_poses_<object>.txt (a pose and its LCP a line), `--heatmap`
dbg/probability_heatmap.png and dbg/overlay_<object>.png, `--sweep N` runs
the chunked sweep (`--sweep-chunk`, `--sweep-checkpoint`,
`--sweep-checkpoint-every`, `--sweep-stop-after`) on the one device. Under
`--sweep` the JAX package's command drops `--cluster` and `--heatmap`; this
one writes the pool's clusters, the heatmap and the overlay of the sweep's
best pose. `--device` picks the device (default cuda; without a card the
commands fail unless given `--device cpu`). `--profile` and the commands
not ported yet exit nonzero with the ROADMAP item that will bring them.
`main(argv)` runs in-process.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys

import numpy as np

# flags of paths not ported yet -> the ROADMAP.md Queue 1 item that ports them
_NOT_PORTED = {
    "profile": "item 8, 'eval, io/bop, stocs-batch, stocs-multi and serve' (profiling)",
}


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


def cmd_stocs_single(argv):
    import torch

    from .config import get_preset
    from .estimator import StocsEstimator, _to_host
    from .io import ply
    from .model import load_model_pack
    from .scene import load_scene

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
                   help="write a profiler trace of the run to DIR (not ported)")
    p.add_argument("--sweep", type=int, default=None, metavar="TOTAL_BASES",
                   help="large hypothesis sweep: process TOTAL_BASES in "
                        "chunks (StocsEstimator.run_sweep) instead of one "
                        "number-of-bases run")
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
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag) not in (None, False):
            print(f"error: --{flag.replace('_', '-')} belongs to a path the "
                  f"PyTorch port does not have yet (ROADMAP.md Queue 1, {item}); "
                  f"use the JAX package's CLI (python -m model_matching_tpu.cli)")
            return 2
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

    scene_out = (
        os.path.join(args.output_root, os.path.basename(args.scene_path.rstrip("/")))
        if args.output_root
        else args.scene_path
    )
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
        # always the one device of the packs (the JAX package's command
        # shards the sweep when it sees several devices)
        best_lcp, best_w, cl_t, cl_s, stats = est.run_sweep(
            args.sweep, chunk=args.sweep_chunk,
            checkpoint_path=args.sweep_checkpoint,
            checkpoint_every=args.sweep_checkpoint_every,
            stop_after_chunks=args.sweep_stop_after,
        )
        if not stats.get("completed", True):
            print(f"sweep: stopped after chunk {stats['next_chunk']} — "
                  f"checkpoint at {args.sweep_checkpoint}; re-run the same "
                  f"command to resume")
            return 0
        out_file = os.path.join(scene_out, f"best_pose_candidate_{args.object}.txt")
        os.makedirs(scene_out, exist_ok=True)
        _write_pose(out_file, best_w)
        print(f"wrote {out_file} (sweep best lcp {best_lcp:.4f})")
        if args.heatmap:
            _write_heatmap(dbg, args.scene_path, args.object, scene, est, model,
                           cfg, live, best_w if best_lcp > 0 else None)
        if args.cluster:
            _write_clusters(
                os.path.join(scene_out, f"clustered_poses_{args.object}.txt"),
                cl_t, cl_s)
        return 0

    result = est.run(coarse_to_fine=not args.no_coarse_to_fine)

    if est.seg_masks is not None:
        # seg_mask_<n>.png debug artifacts, one per base that has a segment
        from .io.image import write_u8

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


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "model-preprocess":
        return cmd_model_preprocess(rest)
    if cmd == "stocs-single":
        return cmd_stocs_single(rest)
    if cmd in ("stocs-batch", "stocs-multi", "serve", "eval"):
        print(f"error: {cmd} is not ported to PyTorch yet (ROADMAP.md Queue 1, "
              f"item 8); use python -m model_matching_tpu.cli {cmd}")
        return 2
    print(f"unknown command {cmd!r}; use model-preprocess or stocs-single")
    return 2


if __name__ == "__main__":
    sys.exit(main())
