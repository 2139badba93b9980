"""One process's sweep on one card against the same process's sweep sharded
over every card in sight (what `stocs-single --sweep` does on a multi-card
host without torchrun), both warm, at the same --sweep and --sweep-chunk,
on a synthetic ycb frame:

    python3 scripts/torch_sweep_mesh.py [--sweep 16384] [--chunk 8192] [--reps 2]
                                        [--out build/sweep_mesh] [--device cuda]

One card runs `StocsEstimator.run_sweep`, as the command does with one card
in sight; every card runs `run_sweep_sharded` over `make_mesh()`. Each
layout sweeps once untimed, then the timed sweeps alternate (one, every,
every, one, ...). Prints a line a timed sweep and a last JSON line with the
bases/s of each layout. `--device cpu` rehearses it on the CPU, the
"every card" layout then four CPU ranks.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sweep", type=int, default=16384)
    p.add_argument("--chunk", type=int, default=8192)
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--out", default=os.path.join(ROOT, "build", "sweep_mesh"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--scale", type=float, default=1.0,
                   help="image and camera scale of the frame (0.25 for a CPU rehearsal)")
    args = p.parse_args(argv)

    import torch

    from model_matching_tpu_torch.config import get_preset
    from model_matching_tpu_torch.estimator import StocsEstimator
    from model_matching_tpu_torch.model import load_model_pack
    from model_matching_tpu_torch.parallel.sharding import make_mesh, run_sweep_sharded
    from model_matching_tpu_torch.preprocess import preprocess_model
    from model_matching_tpu_torch.scene import load_scene
    from model_matching_tpu_torch.synthetic import write_synthetic_scene

    dev = torch.device(args.device)
    scene_dir, cfg, _gt = write_synthetic_scene(args.out, scale=args.scale)
    mdir = os.path.join(args.out, "models", "synthetic_shell")
    model_ply, table = os.path.join(mdir, "model_search.ply"), os.path.join(mdir, "ppf_table.npz")
    preprocess_model(os.path.join(mdir, "textured_vertices.ply"), model_ply, table,
                     get_preset("ycb").preprocess, verbose=False, device=dev)
    model = load_model_pack(model_ply, table, cfg.max_model_points, device=dev)
    scene = load_scene(os.path.join(scene_dir, "rgb.png"), os.path.join(scene_dir, "depth.png"),
                       os.path.join(scene_dir, "probability_maps", "synthetic_shell.png"),
                       None, cfg, device=dev)
    mesh = make_mesh() if dev.type == "cuda" else make_mesh([dev] * 4)
    est = StocsEstimator(model, scene, cfg)

    def one():
        return est.run_sweep(args.sweep, chunk=args.chunk, verbose=False)

    def every():
        return run_sweep_sharded(mesh, model, scene, cfg, args.sweep, chunk=args.chunk,
                                 verbose=False)

    layouts = {"one_card": one, f"{mesh.size}_ranks_one_process": every}
    rates = {k: [] for k in layouts}
    for name, fn in layouts.items():
        fn()
        print(f"{name}: warmed up", flush=True)
    order = list(layouts)
    for r in range(args.reps):
        for name in (order if r % 2 == 0 else order[::-1]):
            t = time.perf_counter()
            best, _w, _ct, _cs, stats = layouts[name]()
            s = time.perf_counter() - t
            rates[name].append(args.sweep / s)
            print(f"{name}: {s:.3f} s, {args.sweep / s:.1f} bases/s, best lcp {best:.4f}, "
                  f"{stats.get('devices', 1)} ranks", flush=True)
    print(json.dumps({"sweep": args.sweep, "chunk": args.chunk,
                      "devices": [str(d) for d in mesh.devices],
                      "bases_per_s": {k: v for k, v in rates.items()},
                      "median": {k: statistics.median(v) for k, v in rates.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
