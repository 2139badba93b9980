"""The sequential instance sampler's base-rounds kernel on the card, timed
beside the plain torch parts it replaces, at the packed preset's width.

    python3 scripts/torch_base_rounds.py [--bases N] [--out chiprun_out/base_rounds.json]

On a full-size packed frame of benchmark/frames.py (layout 3, N = 16,384
lanes, ~11,000 points live) and the box's unstandardized pack, built on
the card:

* device time of one `pre` and one `post` (CUDA events around each part
  with the queue held busy by a sleep kernel, so that no host gap is
  counted), for the kernel launched eagerly and for the plain torch parts
  replayed from CUDA graphs, averaged over the bases of a run;
* the wall time of `sample_instance_bases_stepwise` a base (the median of
  three warm calls of N bases), with the kernel and with the plain parts
  swapped in, both replaying graphs, and whether their outputs are equal
  bit for bit.

Prints one JSON line (also written to `--out`). Needs a CUDA device and
nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmark"))

import torch  # noqa: E402

from model_matching_tpu_torch import flood, instance, rng  # noqa: E402
from model_matching_tpu_torch.ops import base_rounds  # noqa: E402


def packed_frame(dev):
    """(model, scene, cfg) of benchmark/frames.py's packed layout 3."""
    import frames
    import loops

    from model_matching_tpu_torch.config import PreprocessConfig
    from model_matching_tpu_torch.model import load_model_pack
    from model_matching_tpu_torch.preprocess import preprocess_model
    from model_matching_tpu_torch.scene import load_scene

    spec = json.loads((ROOT / "benchmark" / "configs" / "packed.json").read_text())
    cfg = loops.match_config(spec["match"])
    root = tempfile.mkdtemp(prefix="base-rounds-")
    fr = frames.write_frame(root, "bin", 3, 0, cfg.camera.as_tuple(), cfg.image_width,
                            cfg.image_height, cfg.depth_scale, cfg.probability_scale, True)
    frames.write_models(root, "bin", spec["scene"]["source_points"])
    d = os.path.join(root, "models", "box")
    preprocess_model(os.path.join(d, "textured_vertices.ply"),
                     os.path.join(d, "model_search.ply"), os.path.join(d, "ppf_table.npz"),
                     PreprocessConfig(**spec["preprocess"]), verbose=False, device=dev)
    model = load_model_pack(os.path.join(d, "model_search.ply"),
                            os.path.join(d, "ppf_table.npz"), cfg.max_model_points,
                            standardize=False, device=dev)
    rgb, depth, probs, edge = fr.paths(["box"])
    return model, load_scene(rgb, depth, probs[0], edge, cfg, device=dev), cfg


def _kwargs(cfg, bases):
    return dict(num_bases=bases, dispersion=cfg.sample_dispersion,
                tr_disc=cfg.ppf_tr_discretization, rot_disc=cfg.ppf_rot_discretization,
                plane_threshold=cfg.plane_threshold, min_distance_base=cfg.min_distance_base,
                internal_angle_threshold=cfg.internal_angle_threshold,
                flood_sweeps=cfg.flood_fill_sweeps or 8, block=cfg.instance_scan_block)


def sample(model, scene, cfg, bases):
    return instance.sample_instance_bases_stepwise(
        rng.PRNGKey(11), model.table, scene.pos, scene.normal, scene.class_prob,
        scene.edge_prob, scene.pixel, scene.valid, scene.edge_free, **_kwargs(cfg, bases))


def wall_ms_per_base(model, scene, cfg, bases):
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample(model, scene, cfg, bases)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls[1:]) / bases * 1e3, out


def part_device_ms(model, scene, cfg, bases, plain):
    """Mean device ms of `pre` and of `post` over a run of `bases` bases: the
    kernel launched eagerly, or the plain parts replayed from graphs."""
    kw = _kwargs(cfg, bases)
    block = kw["block"]
    s = base_rounds.Rounds(
        model.table, scene.pos, scene.normal, scene.class_prob, scene.edge_prob,
        scene.pixel, scene.valid, scene.edge_free.shape, bases, block, kw["dispersion"],
        kw["tr_disc"], kw["rot_disc"], kw["plane_threshold"], kw["min_distance_base"],
        kw["internal_angle_threshold"])
    n = scene.pos.shape[0]
    keys = instance._base_keys(rng.PRNGKey(11), bases)
    pre = base_rounds.base_pre_reference if plain else base_rounds.base_pre
    post = base_rounds.base_post_reference if plain else base_rounds.base_post
    graphs = None
    times = {"pre": [], "post": []}

    def timed(name, fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)        # the queue busy: no host gap timed
        start.record()
        fn()
        end.record()
        times[name].append((start, end))

    def fill():
        m, conv = flood.flood_fill(s.seed_rc, scene.edge_free, s.max_pix_dist,
                                   fixed_sweeps=kw["flood_sweeps"], return_converged=True)
        s.seg.copy_(m[0])
        s.fill_ok.copy_(conv)
        s.seg_buffer.copy_(torch.where(m[0], (s.row + 1).to(torch.int32), s.seg_buffer))

    for b in range(bases):
        if b % block == 0:
            noise = rng.gumbel_rows(keys[b:b + block].reshape(-1, 2), n, scene.pos.device)
            s.noise[:noise.shape[0] // 4].copy_(noise.reshape(-1, 4, 1, n))
        if plain and b == 1:
            graphs = instance._Graphs(scene.pos.device, dict(pre=lambda: pre(s),
                                                             post=lambda: post(s)))
        run = (lambda name: graphs(name)) if graphs is not None else None
        timed("pre", (lambda: run("pre")) if run else (lambda: pre(s)))
        hit = int(s.cached_id)
        if hit:
            s.seg.copy_(s.masks[hit])
            s.fill_ok.fill_(True)
        else:
            fill()
        timed("post", (lambda: run("post")) if run else (lambda: post(s)))
    torch.cuda.synchronize()
    skip = 1 if plain else 0                 # the plain parts' eager first base
    return {k: statistics.mean(a.elapsed_time(e) for a, e in v[skip:])
            for k, v in times.items()}, s


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bases", type=int, default=256)
    ap.add_argument("--out", default="chiprun_out/base_rounds.json")
    args = ap.parse_args()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    model, scene, cfg = packed_frame(dev)
    res = {"card": card.strip().splitlines()[0] if card.strip() else "unknown",
           "n": scene.pos.shape[0], "live": int(scene.count()), "bases": args.bases}

    kern_ms, kern_out = wall_ms_per_base(model, scene, cfg, args.bases)
    parts_kern, s_kern = part_device_ms(model, scene, cfg, args.bases, plain=False)
    real = base_rounds.base_pre, base_rounds.base_post
    base_rounds.base_pre, base_rounds.base_post = (base_rounds.base_pre_reference,
                                                   base_rounds.base_post_reference)
    try:
        plain_ms, plain_out = wall_ms_per_base(model, scene, cfg, args.bases)
    finally:
        base_rounds.base_pre, base_rounds.base_post = real
    parts_plain, s_plain = part_device_ms(model, scene, cfg, args.bases, plain=True)
    same = all(torch.equal(getattr(kern_out, f), getattr(plain_out, f))
               for f in instance.InstanceSamples._fields)
    res.update(sampler_ms_per_base={"kernel": kern_ms, "plain": plain_ms},
               device_ms={"kernel": parts_kern, "plain_graphs": parts_plain},
               equal=same, valid=int(kern_out.valid.sum()))

    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
