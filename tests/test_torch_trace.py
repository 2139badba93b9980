"""The port's spans and counters (model_matching_tpu_torch/utils/trace.py):
nesting, request ids, the bound, the off mode, the counters, the estimator's
timings read from its spans, the ingest spans on a quarter-size frame, and
the profiler ranges that only `annotate(True)` emits, on the profiler's
clock. CPU only; the file imports no JAX."""

import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from model_matching_tpu_torch.estimator import StocsEstimator
from model_matching_tpu_torch.scene import load_scene
from model_matching_tpu_torch.synthetic import synthetic_setup, write_synthetic_scene
from model_matching_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spans(entries, name=None):
    return [e for e in entries if e.kind == "span" and (name is None or e.name == name)]


def test_spans_nest_with_parents_and_request_ids():
    rec = trace.Recorder()
    with rec.span("a") as a:
        with rec.span("b") as b:
            with rec.span("c") as c:
                pass
        with rec.request() as rid:
            with rec.span("d") as d:
                rec.count("n")
        with rec.request() as rid2:
            pass
    with rec.span("e") as e:
        pass
    assert a.parent is None and e.parent is None
    assert b.parent == a.seq and c.parent == b.seq and d.parent == a.seq
    assert rid != rid2 and d.request == rid and a.request is None and e.request is None
    log = rec.snapshot()
    assert [x.name for x in log.entries] == ["a", "b", "c", "d", "n", "e"]
    assert [x.seq for x in log.entries] == sorted(x.seq for x in log.entries)
    cnt = log.entries[4]
    assert cnt.kind == "count" and cnt.parent == d.seq and cnt.request == rid
    for s in (a, b, c, d, e):
        assert s.t1 >= s.t0 and s.seconds == (s.t1 - s.t0) * 1e-9
    assert a.t0 <= b.t0 <= c.t0 <= c.t1 <= b.t1 <= d.t0 <= d.t1 <= a.t1 <= e.t0
    assert rec.snapshot(since=d.seq).entries[0] is d
    assert trace.phases_ms(log.entries) == pytest.approx(
        {"a": a.seconds * 1e3, "b": b.seconds * 1e3, "d": d.seconds * 1e3,
         "e": e.seconds * 1e3})


def test_a_span_that_raises_still_ends():
    rec = trace.Recorder()
    with pytest.raises(ValueError):
        with rec.span("outer"):
            with rec.span("inner"):
                raise ValueError("x")
    with rec.span("after") as after:
        pass
    assert after.parent is None
    assert all(s.t1 is not None for s in _spans(rec.snapshot().entries))


def test_the_log_is_bounded_and_says_when_it_was_trimmed():
    rec = trace.Recorder(max_entries=8)
    for i in range(6):
        with rec.span(f"s{i}"):
            pass
    assert rec.snapshot().trimmed_at is None and len(rec.snapshot().entries) == 6
    first = rec.snapshot().entries
    for i in range(5):
        rec.count("c", i)
    log = rec.snapshot()
    assert len(log.entries) == 8
    # three spans went; the newest of them started at trimmed_at
    assert log.trimmed_at == first[2].t0
    assert [e.seq for e in log.entries] == list(range(3, 11))
    assert rec.mark() == 11
    assert [e.seq for e in rec.snapshot(since=9).entries] == [9, 10]
    assert rec.total("c") == 10      # totals outlive the log


def test_counters_keep_totals():
    rec = trace.Recorder()
    rec.count("host_reads")
    rec.count("host_reads", 4)
    rec.count("k1.launches")
    assert rec.counters() == {"host_reads": 5, "k1.launches": 1}
    assert rec.total("k2.launches") == 0
    got = [(e.name, e.n) for e in rec.snapshot().entries]
    assert got == [("host_reads", 1), ("host_reads", 4), ("k1.launches", 1)]
    assert all(e.t0 > 0 for e in rec.snapshot().entries)


def test_off_mode_records_nothing_but_a_sync_span_still_syncs(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: synced.append(a))
    rec = trace.Recorder(on=False)
    plain = rec.span("a")
    assert plain is rec.span("b")            # one shared no-op, nothing allocated
    with plain:
        rec.count("host_reads", 2)
    with rec.span("s", sync=True) as s:
        time.sleep(0.001)
    assert synced == [()] and s.seconds >= 0.001
    with rec.span("t", timed=True) as t:
        pass
    assert synced == [()] and t.seconds >= 0
    with rec.span("cpu", sync=torch.device("cpu")):
        pass
    assert synced == [()]                     # nothing to wait for on the CPU
    assert rec.snapshot().entries == [] and rec.mark() == 0
    assert rec.total("host_reads") == 2       # totals are kept
    # recording on: the same sync, and the span is logged
    on = trace.Recorder()
    with on.span("s", sync=True):
        pass
    assert synced == [(), ()] and [e.name for e in on.snapshot().entries] == ["s"]


def test_a_span_costs_microseconds():
    rec = trace.Recorder()

    def one():
        with rec.span("x"):
            pass

    n = 2000
    best = min(_timed(one, n) for _ in range(5))
    # the budget is ~2 us; a loaded test host gets ten times that
    assert best < 20e-6, best


def _timed(fn, n):
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


@pytest.fixture(scope="module")
def tiny():
    return synthetic_setup(num_model=128, num_scene=512, num_bases=16, max_pairs=256,
                           max_congruent=16, device="cpu")


def test_run_timings_are_its_spans(tiny):
    model, scene, cfg = tiny
    mark = trace.mark()
    res = StocsEstimator(model, scene, cfg).run(verbose=False)
    entries = trace.snapshot(mark).entries
    names = {"sample_bases": "estimate.sample", "congruent_sets": "estimate.congruent",
             "rigid_fit": "estimate.fit", "scoring": "estimate.score",
             "icp_refine": "estimate.icp"}
    assert set(res.timings) == set(names)
    (setup,) = _spans(entries, "estimate.setup")
    (run,) = _spans(entries, "estimate.run")
    assert setup.parent is None and run.parent is None
    for key, name in names.items():
        (s,) = _spans(entries, name)
        assert s.parent == run.seq
        assert res.timings[key] == s.seconds
    (read,) = _spans(entries, "estimate.read")
    assert read.parent == run.seq
    reads = [e for e in entries if e.kind == "count" and e.name == "host_reads"]
    assert any(e.parent == read.seq for e in reads)


def test_run_timings_with_recording_off(tiny, monkeypatch):
    model, scene, cfg = tiny
    monkeypatch.setattr(trace.recorder(), "on", False)
    mark = trace.mark()
    res = StocsEstimator(model, scene, cfg).run(verbose=False)
    assert set(res.timings) == {"sample_bases", "congruent_sets", "rigid_fit", "scoring",
                                "icp_refine"}
    assert all(v > 0 for v in res.timings.values())
    assert trace.mark() == mark


def test_load_scene_spans_lie_inside_scene_load(tmp_path):
    scene_dir, cfg, _gt = write_synthetic_scene(str(tmp_path), scale=0.25,
                                                num_source_points=300)
    mark = trace.mark()
    reads = trace.total("host_reads")
    load_scene(f"{scene_dir}/rgb.png", f"{scene_dir}/depth.png",
               f"{scene_dir}/probability_maps/synthetic_shell.png", None, cfg, device="cpu")
    entries = trace.snapshot(mark).entries
    (top,) = _spans(entries, "scene.load")
    assert top.parent is None
    kids = [_spans(entries, n)[0] for n in ("scene.read", "scene.pipeline", "scene.build")]
    for k in kids:
        assert k.parent == top.seq and top.t0 <= k.t0 <= k.t1 <= top.t1
    assert kids[0].t1 <= kids[1].t0 and kids[1].t1 <= kids[2].t0
    # the children cover the load but for a few lines of glue
    covered = sum(k.t1 - k.t0 for k in kids)
    assert covered >= 0.9 * (top.t1 - top.t0)
    assert trace.total("host_reads") - reads >= 2


def _mm_events(prof):
    return [ev for ev in prof.profiler.kineto_results.events()
            if ev.name().startswith("mm.") and ev.device_type() != DeviceType.CUDA]


def test_profiler_ranges_only_under_annotate(tiny):
    model, scene, cfg = tiny
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        StocsEstimator(model, scene, cfg).run(verbose=False)
    assert not [ev for ev in prof.profiler.kineto_results.events()
                if ev.name().startswith("mm.")]
    trace.annotate(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            StocsEstimator(model, scene, cfg).run(verbose=False)
    finally:
        trace.annotate(False)
    names = {ev.name() for ev in _mm_events(prof)}
    assert {"mm.estimate.setup", "mm.estimate.run", "mm.estimate.sample",
            "mm.estimate.score"} <= names


def test_spans_land_on_the_profilers_clock():
    rec = trace.Recorder()
    rec.annotate(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(4):            # the first range of a process starts slowly
            with rec.span(f"probe{i}"):
                time.sleep(0.002)
    spans = {s.name: s for s in _spans(rec.snapshot().entries)}
    events = {ev.name()[3:]: ev for ev in _mm_events(prof)}
    for name in ("probe2", "probe3"):
        ev, s = events[name], spans[name]
        assert abs(ev.start_ns() - trace.to_profiler_ns(s.t0)) < 1_000_000
        assert abs(ev.start_ns() + ev.duration_ns() - trace.to_profiler_ns(s.t1)) < 1_000_000
    np.testing.assert_allclose(trace.to_profiler_ns(0), time.time_ns() - time.perf_counter_ns(),
                               atol=5e6)


def test_serve_logs_the_requests_phases_and_counts(tmp_path, monkeypatch, capsys):
    """`serve` logs a `serve_request` event a request with the request's
    top-level spans and their children, its host reads and its kernel
    launches (none on the CPU)."""
    import dataclasses
    import io
    import json
    import sys

    from model_matching_tpu_torch import cli
    from model_matching_tpu_torch import config as tconfig

    root = str(tmp_path)
    scene_dir, cfg, _gt = write_synthetic_scene(root, scale=0.25, num_source_points=2000)
    real = tconfig.get_preset

    def small(name):
        p = real(name)
        return dataclasses.replace(p, match=dataclasses.replace(
            p.match, camera=cfg.camera, image_width=cfg.image_width,
            image_height=cfg.image_height, voxel_size=0.01, max_scene_points=4096,
            max_pairs_per_bin=2048, maximum_congruent_sets=64))

    monkeypatch.setattr(tconfig, "get_preset", small)
    monkeypatch.setenv("MM_TORCH_LOG_JSON", "1")
    assert cli.main(["model-preprocess", "synthetic_shell", "--repo-path", root,
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    monkeypatch.setattr(sys, "stdin", io.StringIO(f"{scene_dir} synthetic_shell\nquit\n"))
    assert cli.main(["serve", "--repo-path", root, "--device", "cpu",
                     "--number-of-bases", "16"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any(line.startswith("OK ") for line in lines), lines
    (ev,) = [json.loads(line) for line in lines
             if line.startswith("{") and '"serve_request"' in line]
    assert {"scene.load", "scene.read", "scene.pipeline", "scene.build", "estimate.setup",
            "estimate.run", "estimate.sample", "estimate.score"} <= set(ev["phases_ms"])
    assert ev["phases_ms"]["scene.load"] >= ev["phases_ms"]["scene.build"] > 0
    assert ev["host_reads"] >= 4 and ev["k1_launches"] == ev["k2_launches"] == 0
    assert ev["model_loaded"] and not ev["kernels_loaded"] and not ev["kernels_built"]
