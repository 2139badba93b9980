"""Shared arithmetic of the metric readers in benchmark/metrics/. Each reader
takes the run (`run.RunView`) and returns a number, or None where it finds
nothing to read, and the harness then leaves the metric out."""

from __future__ import annotations

import statistics

import bounds


def frame_ms(records, q):
    """The q-th percentile (50 or 90) of request latency in ms, over every
    request of the window (failed ones too)."""
    lat = [(r.t1 - r.t0) * 1e3 for r in records]
    if not lat:
        return None
    if q == 50 or len(lat) == 1:
        return statistics.median(lat)
    return statistics.quantiles(lat, n=100, method="inclusive")[q - 1]


def mean_ms(records, fn):
    vals = [fn(r) for r in records if r.ok]
    return 1e3 * sum(vals) / len(vals) if vals else None


def roofline(run, kernel):
    """Share (%) of a kernel's bound, summed over its launches in the traced
    requests, in its device time there."""
    if run.trace is None or run.launches is None or run.peaks is None:
        return None
    if kernel == "k1":
        bound = run.launches.k1_bound_seconds(run.peaks)
        dev_s = run.trace.device_s_matching(bounds.K1_KERNEL)
    else:
        bound = run.launches.k2_bound_seconds(run.peaks)
        dev_s = run.trace.device_s_matching(*bounds.K2_KERNELS)
    if bound <= 0 or dev_s <= 0:
        return None
    return 100.0 * bound / dev_s


def device_idle(run):
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def kernels_per(run, what):
    if run.trace is None or run.trace.kernels == 0:
        return None
    n = (len(run.traced_records) if what == "request"
         else sum(r.bases for r in run.traced_records))
    return run.trace.kernels / n if n else None
