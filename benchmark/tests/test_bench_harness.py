"""CPU tests of the harness at tiny sizes: frames from a seed, the metric
arithmetic on a synthetic trace, the schema of the last line, and a cell, a
configuration, a traffic mix and a metric added as new files only."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import bounds
import frames
import readers
import run
import trace
import loops
from loops import Record

ROOT = run.ROOT


# limits at the tiny size: a quarter-size frame puts many voxel centroids
# exactly on a pixel boundary, where the program's rounding and the
# reference's pick neighbouring pixels, so probabilities and LCPs differ
# more than at full size; 16 bases on a quarter-size frame find a pose
# 2.8-2.9 mm (ADD-S) from the truth, 0.4% short of its LCP, and 4.0-4.7 mm
# and 3.8-11.9% short without the ICP polish
TINY_LIMITS = {"failed": 0, "model_miss": 0.01, "scene_miss": 0.01, "normal_miss": 0.01,
               "lcp_gap": 0.03, "adds_mm": 10.0, "lcp_short": 0.02}


def tiny_spec(cell):
    """The cell at a size the CPU runs in seconds: a quarter-size frame,
    16 bases, small pair bins, two frames."""
    spec = run.load_spec(cell)
    spec["config"]["match"].update(number_of_bases=16, maximum_congruent_sets=32,
                                   max_pairs_per_bin=1024)
    spec["config"]["scene"].update(frames=2)
    spec["cell"].update(warmup_requests=1, traced_requests=1, checked_requests=2,
                        limits=dict(TINY_LIMITS))
    if spec["traffic"]["loop"] == "sweep":
        spec["traffic"].update(bases=64, chunk=32)
    return spec


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_frames_come_from_the_seed(tmp_path):
    cam = (1066.778 / 4, 312.986 / 4, 1067.487 / 4, 241.31 / 4)
    a = frames.write_frames(tmp_path / "a", "shell", 4, 2**31 + 99, cam, 160, 120, 1e-4, 1e-4, False)
    b = frames.write_frames(tmp_path / "b", "shell", 4, 2**31 + 99, cam, 160, 120, 1e-4, 1e-4, False)
    c = frames.write_frames(tmp_path / "c", "shell", 4, 7, cam, 160, 120, 1e-4, 1e-4, False)
    for x, y in zip(a, b):
        assert np.array_equal(x.depth, y.depth) and np.array_equal(x.rgb, y.rgb)
    # another seed: the same frames in another order
    key = lambda f: f.depth.tobytes()
    assert sorted(map(key, a)) == sorted(map(key, c))
    assert list(map(key, a)) != list(map(key, c))


def test_bin_frames_carry_an_edge_map(tmp_path):
    cam = tuple(v / 4 for v in (615.96, 308.11, 615.96, 246.33))
    fr = frames.write_frames(tmp_path, "bin", 1, 3, cam, 160, 120, 1 / 8000, 1e-4, True)[0]
    assert fr.has_edge and (fr.edge == 0).any() and len(fr.truth) == 8
    assert os.path.exists(os.path.join(fr.scene_dir, "probability_maps", "edge.png"))


def _iv(name, s, e):
    return trace.Interval(name, s, e)


def test_trace_reduction_on_a_synthetic_trace():
    device = [_iv("dense_gate_kernel<true,true>", 1.0, 1.5), _iv("row_gather_vec4<int>", 1.4, 2.0),
              _iv("Memcpy HtoD", 3.0, 3.5), _iv("elementwise", 9.5, 11.0)]
    spans = [_iv(trace.WINDOW_SPAN, 0.0, 10.0), _iv("bench.ingest", 0.0, 2.5),
             _iv("bench.estimate", 2.5, 10.0)]
    s = trace.summarize(device, spans)
    assert s.window_s == 10.0
    assert s.busy_s == pytest.approx(1.0 + 0.5 + 0.5)      # clipped at the window's end
    assert s.kernels == 3                                  # the copy is no kernel
    assert s.device_s_matching(bounds.K1_KERNEL) == pytest.approx(0.5)
    assert s.device_s_matching(*bounds.K2_KERNELS) == pytest.approx(0.6)
    assert s.idle_gaps[0] == ["bench.estimate", pytest.approx(6.0)]
    # gaps 0-1 s and 2-3 s (its midpoint in both spans: the shorter is innermost)
    assert [g[0] for g in s.idle_gaps] == ["bench.estimate", "bench.ingest", "bench.ingest"]
    assert s.device_ops[0][0] == "elementwise"


class _Launches:
    def k1_bound_seconds(self, peaks):
        return 0.05

    def k2_bound_seconds(self, peaks):
        return 0.3


class _Run:
    def __init__(self, summary):
        self.trace, self.launches = summary, _Launches()
        self.peaks = bounds.PEAKS["NVIDIA H100 80GB HBM3"]
        self.traced_records = [Record(i=0, frame=0, bases=100), Record(i=1, frame=1, bases=100)]
        self.records = [Record(i=k, frame=0, t0=0.0, t1=(k + 1) / 1e3, ok=True,
                               ingest_s=0.002, timings={"sample_bases": 0.001})
                        for k in range(10)]
        self.window_s, self.setup_s = 2.0, 5.0


def test_metric_arithmetic():
    device = [_iv("dense_gate_kernel", 0.0, 0.5), _iv("row_gather_scalar", 1.0, 1.6)]
    r = _Run(trace.summarize(device, [_iv(trace.WINDOW_SPAN, 0.0, 4.0)]))
    assert run.read_metric("k1_roofline.serve", r) == pytest.approx(10.0)
    assert run.read_metric("k2_roofline.sweep", r) == pytest.approx(50.0)
    assert run.read_metric("device_idle.serve", r) == pytest.approx(100 * (1 - 1.1 / 4))
    assert run.read_metric("kernels_per_frame.serve", r) == pytest.approx(1.0)
    assert run.read_metric("kernels_per_base.sweep", r) == pytest.approx(0.01)
    assert run.read_metric("frame_ms.p50", r) == pytest.approx(5.5)
    assert run.read_metric("frame_ms.p90", r) == pytest.approx(float(np.percentile(
        np.arange(1, 11), 90)))
    assert run.read_metric("ingest_ms.serve", r) == pytest.approx(2.0)
    assert run.read_metric("sample_ms.serve", r) == pytest.approx(1.0)
    assert run.read_metric("setup_s", r) == 5.0
    # nothing to read: the metric is left out, never reported as 0
    r.trace = None
    assert run.read_metric("k1_roofline.serve", r) is None
    assert run.read_metric("device_idle.sweep", r) is None


def test_every_metric_has_a_reader_and_every_cell_its_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"))
    for w in bench["workloads"]:
        spec = run.load_spec(w["name"])
        assert spec["end_to_end"] and spec["per_layer"]
        assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
        assert {"failed", "model_miss", "scene_miss", "normal_miss", "lcp_gap",
                "lcp_short"} <= set(spec["cell"]["limits"]) <= {
                    "failed", "model_miss", "scene_miss", "normal_miss", "lcp_gap",
                    "lcp_short", "adds_mm"}


def test_new_files_are_found_without_editing_any(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "ycb.json").read_text())
    cfg["name"] = "ycb_far"
    cfg["match"]["number_of_bases"] = 300
    (b / "configs" / "ycb_far.json").write_text(json.dumps(cfg))
    (b / "traffic" / "serve_x.json").write_text(json.dumps({"loop": "once"}))
    (b / "traffic" / "once.py").write_text(
        "STANDARDIZE = True\n\n\ndef request(session, rec, fr):\n    rec.ok = True\n")
    (b / "cells" / "ycb_far.serve_x.json").write_text(json.dumps(
        {"warmup_requests": 1, "traced_requests": 1, "checked_requests": 1, "limits": {}}))
    (b / "metrics" / "answers.serve_x.py").write_text(
        "def read(run):\n    return len(run.records)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ycb_far", "source": "x",
                             "file": "benchmark/configs/ycb_far.json", "reduced": []})
    bench["workloads"].append({"name": "ycb_far.serve_x", "config": "ycb_far",
                               "traffic": "serve_x", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "answers.serve_x", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "service",
                               "moves": "frame_ms.p50", "workloads": ["ycb_far.serve_x"]})
    bench["end_to_end"][0]["workloads"].append("ycb_far.serve_x")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run.load_spec("ycb_far.serve_x", root=str(tmp_path))
    assert spec["config"]["match"]["number_of_bases"] == 300
    assert spec["traffic"] == {"loop": "once"}
    # the new request loop is found by its name, with the generic closed loop
    session = loops.Session(spec, 1, device="cpu")
    assert session.loop.STANDARDIZE is True and not hasattr(session.loop, "window")
    assert [m["name"] for m in spec["per_layer"]] == ["answers.serve_x"]
    assert run.read_metric("answers.serve_x", _Run(None), root=str(tmp_path)) == 10


def test_a_run_prints_the_result_line():
    out = run.execute(tiny_spec("ycb.serve"), 2**31 + 5, 0.1, 0, device="cpu", scale=0.25)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"frame_ms.p50", "frame_ms.p90", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(out)


def test_without_a_card_a_run_fails_and_prints_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "ycb.serve", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for tr in ("0", "1"):
        p = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                            "--workload", "ycb.serve", "--seed", "2147483659", "--seconds", "5",
                            "--trace", tr], capture_output=True, text=True, timeout=600,
                           cwd=ROOT)
        assert p.returncode == 0, p.stderr[-3000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        assert line["correct"] is True and line["device"]["platform"] == "gpu", line
