"""The readers of the program's spans and counters (benchmark/spans.py) on a
synthetic log: entries are taken by their start inside an answered request
of the window, and an empty or trimmed log gives None."""

import collections

import pytest

import run
import spans
from loops import Record

S = collections.namedtuple("S", "seq name t0 t1 parent request")
S.kind = "span"
C = collections.namedtuple("C", "seq name t0 n parent request")
C.kind = "count"
Log = collections.namedtuple("Log", "entries trimmed_at")

MS = 1_000_000      # ns


def _records():
    # three requests of the window, 10 ms each, 5 ms apart; the second failed
    return [Record(i=0, frame=0, t0=0.100, t1=0.110, ok=True, bases=100),
            Record(i=1, frame=1, t0=0.115, t1=0.125, ok=False, bases=100),
            Record(i=2, frame=2, t0=0.130, t1=0.140, ok=True, bases=300)]


def _log(trimmed_at=None):
    t = 100 * MS
    e = [
        S(0, "scene.read", t - 5 * MS, t - 4 * MS, None, None),      # set-up: before the window
        S(1, "scene.load", t, t + 6 * MS, None, None),
        S(2, "scene.read", t + 1 * MS, t + 2 * MS, 1, None),
        C(3, "host_reads", t + 3 * MS, 2, 1, None),
        S(4, "estimate.run", t + 6 * MS, t + 9 * MS, None, None),     # 1 ms untraced
        S(5, "scene.read", t + 16 * MS, t + 19 * MS, None, None),     # the failed request
        C(6, "host_reads", t + 17 * MS, 50, None, None),
        S(7, "scene.load", t + 30 * MS, t + 38 * MS, None, None),
        S(8, "scene.read", t + 30 * MS, t + 33 * MS, 7, None),
        S(9, "scene.read", t + 34 * MS, t + 35 * MS, 7, None),
        C(10, "host_reads", t + 35 * MS, 4, 7, None),
        S(11, "estimate.run", t + 37 * MS, t + 40 * MS, None, None),  # overlaps scene.load
        S(12, "scene.read", t + 45 * MS, t + 46 * MS, None, None),    # after the window
        C(13, "host_reads", t + 45 * MS, 99, None, None),
    ]
    return Log(e, trimmed_at)


def test_spans_outside_the_window_or_a_failed_request_are_left_out():
    rec, log = _records(), _log()
    # request 0: 1 ms of scene.read; request 2: 3 + 1 ms
    assert spans.span_ms_per_request(rec, log, "scene.read") == pytest.approx(2.5)
    assert spans.span_ms_mean(rec, log, "scene.read") == pytest.approx(5 / 3)
    assert spans.count_per_request(rec, log, "host_reads") == pytest.approx(3.0)
    assert spans.count_per_base(rec, log, "host_reads") == pytest.approx(6 / 400)
    # request 0: 10 ms less 9 covered; request 2: all 10 covered
    assert spans.untraced_ms(rec, log) == pytest.approx(0.5)


def test_nothing_to_read_gives_none():
    rec = _records()
    assert spans.span_ms_per_request(rec, _log(), "multi.align") is None
    assert spans.span_ms_mean(rec, _log(), "sweep.chunk") is None
    assert spans.count_per_request(rec, _log(), "instance.flood_fills") is None
    empty = Log([], None)
    for fn in (lambda lg: spans.span_ms_per_request(rec, lg, "scene.read"),
               lambda lg: spans.count_per_request(rec, lg, "host_reads"),
               lambda lg: spans.untraced_ms(rec, lg)):
        assert fn(None) is None and fn(empty) is None
        # trimmed past the window's first request: incomplete
        assert fn(_log(trimmed_at=101 * MS)) is None
        # trimmed before it: complete
        assert fn(_log(trimmed_at=95 * MS)) is not None
    assert spans.span_ms_per_request([], _log(), "scene.read") is None


def test_the_readers_read_the_programs_log():
    from model_matching_tpu_torch.utils import trace

    class Run:
        pass

    r = Run()
    mark = trace.mark()
    with trace.span("scene.load"):
        with trace.span("scene.read"):
            pass
        trace.count("host_reads", 3)
    after = trace.snapshot(mark).entries
    lo, hi = after[0].t0 / 1e9 - 1e-6, after[0].t1 / 1e9 + 1e-6
    r.records = [Record(i=0, frame=0, t0=lo, t1=hi, ok=True, bases=10)]
    assert run.read_metric("ingest_read_ms.serve", r) > 0
    assert run.read_metric("host_reads_per_frame.serve", r) == 3
    assert run.read_metric("host_reads_per_base.sweep", r) == pytest.approx(0.3)
    assert run.read_metric("untraced_ms.serve", r) == pytest.approx(0.002, abs=1e-3)
    assert run.read_metric("align_ms.serve", r) is None
