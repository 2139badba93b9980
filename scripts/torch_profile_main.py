"""Profile the PyTorch port's main path on one GPU.

    python3 scripts/torch_profile_main.py [--path class|instance|sweep|multi]
        [--bases 100] [--out DIR] [--trace]

--path class (the default) runs the class-path estimator at the
chip_smoke.py size (480 model points, 16,384 scene points, 20,480 pairs per
bin); --path instance runs the instance path on the 640x480 synthetic scene
with an edge map, ingested from files written under build/ (ycb preset,
--bases bases); --path sweep runs one class-path sweep chunk of --bases
bases (run_sweep) on the same scene without the edge map; --path multi runs
multi.match_all_objects for the three objects of the 640x480 three-object
scene (synthetic.write_synthetic_multi_scene, class path, ycb preset,
--bases bases, packs standardized as stocs-multi loads them) and first
times align_models alone (its table rebuilds run on the card, so the clock
stops after a synchronize). Each runs once to
warm up, then once under torch.profiler, on a fresh estimator (the instance
path leaves its decayed prior on the estimator). Prints the per-phase wall
times, the number of device kernels, the device-busy share of the profiled
run (union of kernel intervals over their span), and the top operators by
device time; writes the full table under --out (for --path class, or with
--trace, also the Chrome trace).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _busy_share(events, t_lo, t_hi):
    spans = sorted((max(e[0], t_lo), min(e[1], t_hi)) for e in events
                   if e[1] > t_lo and e[0] < t_hi)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / max(t_hi - t_lo, 1e-9)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("class", "instance", "sweep", "multi"),
                    default="class")
    ap.add_argument("--bases", type=int, default=100)
    ap.add_argument("--out", default="chiprun_out/profile")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from model_matching_tpu_torch.estimator import StocsEstimator
    from model_matching_tpu_torch.synthetic import synthetic_setup

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    if args.path == "class":
        model, scene, cfg = synthetic_setup(num_model=480, num_scene=16384,
                                            num_bases=args.bases, max_pairs=20480,
                                            max_congruent=200, seed=3, device=dev)
    elif args.path == "multi":
        models, scene, probs, cfg = _multi_from_files(dev, args.bases)
    else:
        model, scene, cfg = _scene_from_files(dev, args.path == "instance", args.bases)

    def once():
        if args.path == "multi":
            from model_matching_tpu_torch.multi import match_all_objects

            best, _poses, nhyp = match_all_objects(models, scene, probs, cfg)
            return {"best_lcp": best.tolist(), "hypotheses": nhyp.tolist()}
        est = StocsEstimator(model, scene, cfg)
        if args.path == "sweep":
            stats = est.run_sweep(args.bases, chunk=args.bases, verbose=False)[4]
            return {k: stats[k] for k in ("seconds", "bases_per_sec", "hypotheses",
                                          "hypotheses_per_sec")}
        res = est.run(verbose=False)
        return {k: round(v * 1e3, 3) for k, v in res.timings.items()}

    once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"{args.path} path, {args.bases} bases: profiled run {wall * 1e3:.3f} ms; "
          + {"sweep": "stats ", "multi": "result "}.get(args.path, "timings_ms ")
          + json.dumps(report))
    kernels = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if kernels:
        lo = min(s for s, _ in kernels)
        hi = max(e for _, e in kernels)
        dev_total = sum(e - s for s, e in kernels)
        print(f"device kernels {len(kernels)}; summed device time "
              f"{dev_total / 1e3:.3f} ms; busy share over the kernel span "
              f"{_busy_share(kernels, lo, hi):.4f}; span {(hi - lo) / 1e3:.3f} ms")
    else:
        print("the profiler recorded no device time")
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
    print(table)
    os.makedirs(args.out, exist_ok=True)
    if args.trace or args.path == "class":
        prof.export_chrome_trace(os.path.join(args.out, f"trace_{args.path}.json"))
    with open(os.path.join(args.out, f"ops_{args.path}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=200))


def _multi_from_files(dev, bases):
    """The 640x480 three-object scene, its three preprocessed models loaded
    as stocs-multi loads them, and the wall time of align_models alone
    to the end of its device work (warm, median of 3, printed)."""
    import dataclasses

    import torch

    from model_matching_tpu_torch import cli
    from model_matching_tpu_torch.model import load_model_pack
    from model_matching_tpu_torch.multi import align_models
    from model_matching_tpu_torch.scene import load_scene_multi
    from model_matching_tpu_torch.synthetic import MULTI_SHELLS, write_synthetic_multi_scene

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "build", "profile_multi")
    scene_dir, cfg, _gts = write_synthetic_multi_scene(root)
    objs = [name for name, *_ in MULTI_SHELLS]
    models = []
    for obj in objs:
        if cli.main(["model-preprocess", obj, "--repo-path", root]) != 0:
            raise RuntimeError("model-preprocess failed")
        mdir = os.path.join(root, "models", obj)
        models.append(load_model_pack(os.path.join(mdir, "model_search.ply"),
                                      os.path.join(mdir, "ppf_table.npz"),
                                      cfg.max_model_points, standardize=True, device=dev))
    maps = os.path.join(scene_dir, "probability_maps")
    scene, probs = load_scene_multi(os.path.join(scene_dir, "rgb.png"),
                                    os.path.join(scene_dir, "depth.png"),
                                    [os.path.join(maps, f"{o}.png") for o in objs],
                                    None, cfg, device=dev)
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        align_models(models)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"align_models of {len(objs)} standardized packs, warm: median "
          f"{sorted(walls[1:])[1] * 1e3:.3f} ms over 3")
    return models, scene, probs, dataclasses.replace(cfg, number_of_bases=bases)


def _scene_from_files(dev, edge, bases):
    """The 640x480 synthetic scene (with or without its edge map) and its
    preprocessed model, written under build/ and loaded at the ycb preset."""
    import dataclasses

    from model_matching_tpu_torch import cli
    from model_matching_tpu_torch.model import load_model_pack
    from model_matching_tpu_torch.scene import load_scene
    from model_matching_tpu_torch.synthetic import write_synthetic_scene

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "build", "profile_files")
    obj = "synthetic_shell"
    scene_dir, cfg, _gt = write_synthetic_scene(root, obj, edge=True)
    if cli.main(["model-preprocess", obj, "--repo-path", root]) != 0:
        raise RuntimeError("model-preprocess failed")
    mdir = os.path.join(root, "models", obj)
    model = load_model_pack(os.path.join(mdir, "model_search.ply"),
                            os.path.join(mdir, "ppf_table.npz"),
                            cfg.max_model_points, device=dev)
    maps = os.path.join(scene_dir, "probability_maps")
    scene = load_scene(os.path.join(scene_dir, "rgb.png"),
                       os.path.join(scene_dir, "depth.png"),
                       os.path.join(maps, f"{obj}.png"),
                       os.path.join(maps, "edge.png") if edge else None,
                       cfg, device=dev)
    return model, scene, dataclasses.replace(cfg, number_of_bases=bases)


if __name__ == "__main__":
    main()
