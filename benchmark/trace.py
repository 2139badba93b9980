"""Device trace of the traced requests: capture with torch.profiler, and the
reduction from its events to busy time, kernel counts and times by name,
and the breakdown (top device operations, longest idle gaps named by the
benchmark span the host was in).

The traced window is the `bench.traced` span, which ends after a
`torch.cuda.synchronize()`: idle time before the first kernel and after
the last counts, unlike a busy share taken over the span of the kernels.
"""

from __future__ import annotations

import dataclasses

WINDOW_SPAN = "bench.traced"


@dataclasses.dataclass
class Interval:
    name: str
    start: float     # seconds, the trace's clock
    end: float


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: int
    device_s_by_name: dict
    device_ops: list     # [[name, seconds]] most time first, at most 10
    idle_gaps: list      # [[span name, seconds]] longest first, at most 10

    def device_s_matching(self, *parts):
        return sum(s for n, s in self.device_s_by_name.items() if any(p in n for p in parts))


def union_length(intervals, lo, hi):
    """Length of the union of [start, end) intervals clipped to [lo, hi], and
    the merged intervals."""
    spans = sorted((max(i.start, lo), min(i.end, hi)) for i in intervals
                   if i.end > lo and i.start < hi)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _innermost(spans, t):
    best = None
    for s in spans:
        if s.start <= t <= s.end and (best is None or s.end - s.start < best.end - best.start):
            best = s
    return best.name if best else "host"


def summarize(device, spans, top=10):
    """device: Intervals of operations on the device; spans: Intervals of the
    benchmark's host spans, one of them WINDOW_SPAN."""
    win = [s for s in spans if s.name == WINDOW_SPAN]
    if not win:
        raise ValueError(f"the trace has no {WINDOW_SPAN} span")
    lo, hi = win[0].start, win[0].end
    inside = [d for d in device if d.end > lo and d.start < hi]
    busy, merged = union_length(inside, lo, hi)
    by_name = {}
    for d in inside:
        by_name[d.name] = by_name.get(d.name, 0.0) + (d.end - d.start)
    kernels = sum(1 for d in inside if not d.name.startswith(("Memcpy", "Memset")))
    edges = [lo] + [x for m in merged for x in m] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    inner = [s for s in spans if s.name != WINDOW_SPAN]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_innermost(inner, (a + b) / 2), b - a] for a, b in gaps[:top]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return TraceSummary(hi - lo, busy, kernels, by_name,
                        [[n[:160], s] for n, s in ops], idle)


def _ns(ev, what):
    fn = getattr(ev, f"{what}_ns", None)
    return fn() if fn else getattr(ev, f"{what}_us")() * 1e3


def capture(fn):
    """Run fn() under torch.profiler inside the WINDOW_SPAN span, ending on
    a device synchronize, and reduce the trace. Benchmark spans are the
    record_function ranges whose names start with `bench.`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            fn()
            torch.cuda.synchronize()
    device, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start") * 1e-9
        iv = Interval(ev.name(), start, start + _ns(ev, "duration") * 1e-9)
        if iv.name.startswith("bench."):
            # a record_function range shows on the host, and again on the
            # device as an annotation, which is no device work
            if ev.device_type() != DeviceType.CUDA:
                spans.append(iv)
        elif ev.device_type() == DeviceType.CUDA:
            device.append(iv)
    return summarize(device, spans)
