"""The benchmark's frozen copies held to the port's originals on fixed
inputs: the PNG and PLY writers, the shell and bin frames for a fixed pose,
K1's and K2's byte and operation counts, and the busy-interval union."""

import filecmp
import importlib.util
import os
import random

import numpy as np
import pytest
import torch

import bounds
import frames
import trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _same_file(a, b):
    assert filecmp.cmp(a, b, shallow=False), f"{a} and {b} differ"


def test_png_writers_write_the_ports_bytes(tmp_path):
    from model_matching_tpu_torch.io import image

    rng = np.random.default_rng(1)
    cases = [("u8", rng.integers(0, 256, (7, 9), dtype=np.uint8), frames.write_u8, image.write_u8),
             ("u16", rng.integers(0, 65536, (5, 11), dtype=np.uint16), frames.write_u16,
              image.write_u16),
             ("rgb", rng.integers(0, 256, (6, 4, 3), dtype=np.uint8), frames.write_rgb,
              image.write_rgb)]
    for name, img, mine, theirs in cases:
        mine(tmp_path / f"a_{name}.png", img)
        theirs(str(tmp_path / f"b_{name}.png"), img)
        _same_file(tmp_path / f"a_{name}.png", tmp_path / f"b_{name}.png")


def test_ply_writer_writes_the_ports_bytes(tmp_path):
    from model_matching_tpu_torch.io import ply

    pos, nrm = frames.shell_points(np.random.default_rng(2), 50, frames.SHELL_AXES)
    col = np.tile([200.0, 60.0, 40.0], (50, 1))
    frames.write_ply(tmp_path / "a.ply", pos, nrm, col)
    ply.write_ply(str(tmp_path / "b.ply"), pos, nrm, col)
    _same_file(tmp_path / "a.ply", tmp_path / "b.ply")


@pytest.mark.parametrize("seed", [0, 3])
def test_shell_frame_is_the_ports_at_its_pose(tmp_path, seed):
    from model_matching_tpu_torch.synthetic import write_synthetic_scene

    scene_dir, cfg, gt = write_synthetic_scene(str(tmp_path / "port"), scale=0.25,
                                               num_source_points=300, seed=seed)
    cam = cfg.camera.as_tuple()
    rgb, depth, probs, _seen = frames.render_shells(
        cam, cfg.image_width, cfg.image_height, cfg.depth_scale, cfg.probability_scale,
        [(frames.SHELL_AXES, gt)], np.random.default_rng(seed))
    out = tmp_path / "mine"
    out.mkdir()
    frames.write_rgb(out / "rgb.png", rgb)
    frames.write_u16(out / "depth.png", depth)
    frames.write_u16(out / "prob.png", probs[0])
    _same_file(out / "rgb.png", os.path.join(scene_dir, "rgb.png"))
    _same_file(out / "depth.png", os.path.join(scene_dir, "depth.png"))
    _same_file(out / "prob.png", os.path.join(scene_dir, "probability_maps",
                                              "synthetic_shell.png"))
    pos, nrm = frames.shell_points(np.random.default_rng(seed), 300, frames.SHELL_AXES)
    frames.write_ply(out / "src.ply", pos, nrm, np.tile([200.0, 60.0, 40.0], (300, 1)))
    _same_file(out / "src.ply", tmp_path / "port" / "models" / "synthetic_shell" /
               "textured_vertices.ply")


def test_bin_frame_is_the_ports_at_its_layout(tmp_path):
    from model_matching_tpu_torch.synthetic import write_synthetic_packed_scene

    seed = 4
    scene_dir, cfg, boxes = write_synthetic_packed_scene(
        str(tmp_path / "port"), scale=0.25, num_source_points=400, seed=seed)
    floor, mine_boxes = frames.bin_poses(seed)
    assert all(np.array_equal(a, b) for a, b in zip(mine_boxes, boxes))
    rgb, depth, prob, seen = frames.render_bin(
        cfg.camera.as_tuple(), cfg.image_width, cfg.image_height, cfg.depth_scale,
        cfg.probability_scale, floor, mine_boxes, np.random.default_rng(seed))
    out = tmp_path / "mine"
    out.mkdir()
    frames.write_rgb(out / "rgb.png", rgb)
    frames.write_u16(out / "depth.png", depth)
    frames.write_u16(out / "prob.png", prob)
    frames.write_u8(out / "edge.png", frames.edge_of_ids(seen))
    maps = os.path.join(scene_dir, "probability_maps")
    _same_file(out / "rgb.png", os.path.join(scene_dir, "rgb.png"))
    _same_file(out / "depth.png", os.path.join(scene_dir, "depth.png"))
    _same_file(out / "prob.png", os.path.join(maps, "packed_box.png"))
    _same_file(out / "edge.png", os.path.join(maps, "edge.png"))
    pos, nrm = frames.box_points(np.random.default_rng(seed), 400, frames.PACKED_BOX)
    frames.write_ply(out / "src.ply", pos, nrm, np.tile([230.0, 230.0, 235.0], (400, 1)))
    _same_file(out / "src.ply", tmp_path / "port" / "models" / "packed_box" /
               "textured_vertices.ply")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gate_launch(b, p, q, q_tile, live, seed):
    """Arguments of a dense-gate launch with lanes compacted valid-first and
    few cells, so that equal cells are common."""
    g = torch.Generator().manual_seed(seed)
    p_cell = torch.randint(0, 40, (b, p), generator=g, dtype=torch.int32)
    q_cell = torch.randint(0, 40, (b, q), generator=g, dtype=torch.int32)
    p_count = torch.randint(1, p + 1, (b,), generator=g, dtype=torch.int32)
    q_count = torch.randint(1, q + 1, (b,), generator=g, dtype=torch.int32)
    p_cell[torch.arange(p)[None] >= p_count[:, None]] = -1
    q_cell[torch.arange(q)[None] >= q_count[:, None]] = -2
    args = (torch.randn(b, 8, p, generator=g), torch.randn(b, 8, q, generator=g), p_cell, q_cell,
            torch.randint(0, 1 << 20, (b, p), generator=g, dtype=torch.int32),
            torch.randint(0, 1 << 20, (b, q), generator=g, dtype=torch.int32),
            torch.rand(b, generator=g), 0.3, 0.005 ** 2, (1 << 14) - 1, 1 << 30)
    kw = {"q_tile": q_tile, "skip_dist": bool(seed % 2), "p_count": p_count,
          "q_count": q_count, "n_sub": 16, "check_cos": True}
    if live:
        n_pt = -(-p // 256)
        kw["live"] = torch.randint(0, 2, (b, n_pt, q // q_tile), generator=g, dtype=torch.int32)
    return args, kw


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("shape", [(2, 300, 512, 256), (3, 600, 1024, 512)])
def test_gate_counts_are_chip_smokes(shape, live):
    from model_matching_tpu_torch.ops.dense_gate import dense_gate_reference

    cs = _chip_smoke()
    args, kw = _gate_launch(*shape, live, seed=sum(shape) + live)
    theirs = cs._gate_bound(torch, dense_gate_reference, args, kw, ms=1e9)
    nbytes, ops = bounds.gate_launch_cost(args, kw)
    assert nbytes == theirs["bytes"]
    b, p = args[2].shape
    assert ops == b * (p + args[3].shape[1]) + 14 * theirs["same_cell_pairs"]
    peaks = {"hbm_bytes_per_s": cs._HBM_BYTES_PER_S, "fp32_ops_per_s": cs._FP32_OPS_PER_S}
    assert bounds.bound_seconds(nbytes, ops, peaks) * 1e3 == pytest.approx(
        theirs["bound_ms"], rel=1e-12)


def test_gather_bytes_are_chip_smokes(monkeypatch):
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "_time_ms", lambda torch, fn, runs=10: 1.0)
    monkeypatch.setattr(cs, "_device_ms", lambda torch, fn, runs=10: 1.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    g = torch.Generator().manual_seed(9)
    cases = []
    for rows, c, n in ((64, 8, 100), (500, 24, 1000), (37, 4, 7)):
        tab = torch.randn(rows, c, generator=g)
        idx = torch.randint(0, rows, (n,), generator=g)
        cases.append((f"case [{rows}, {c}] x {n}", tab, idx))
    rows, _err = cs._check_gathers(torch, cases)
    for (_name, tab, idx), row in zip(cases, rows):
        assert bounds.gather_launch_bytes(tab, idx) == row["bytes"]
        assert bounds.gather_launch_bytes(tab, idx.to(torch.int32).reshape(-1, 1)) < row["bytes"]


def test_busy_union_is_the_profile_scripts():
    spec = importlib.util.spec_from_file_location(
        "torch_profile_main", os.path.join(ROOT, "scripts", "torch_profile_main.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rnd = random.Random(5)
    for _ in range(20):
        ev = []
        for _k in range(rnd.randint(0, 30)):
            s = rnd.uniform(0, 10)
            ev.append((s, s + rnd.uniform(0, 2)))
        lo, hi = rnd.uniform(-1, 3), rnd.uniform(6, 12)
        busy, _merged = trace.union_length([trace.Interval("k", s, e) for s, e in ev], lo, hi)
        assert busy / (hi - lo) == pytest.approx(mod._busy_share(ev, lo, hi), abs=1e-12)
