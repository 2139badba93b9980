"""What the port's span recorder (model_matching_tpu_torch/utils/trace.py)
costs and sees, on the card:

    python3 scripts/torch_trace_cost.py [--cells ycb.serve,packed.serve] [--seed N]
                                        [--out build/trace_cost.json]

(`--device cpu --scale 0.25` rehearses it on the CPU at a quarter of the
frame, without the sync report.)

1. the host cost of one span and one counter increment (timeit, the least
   of several repeats), recording on and off;
2. for one warm request of each cell (the benchmark's own set-up and request
   loop, benchmark/loops.py): the syncs that
   `torch.cuda.set_sync_debug_mode("warn")` reports, grouped by the line of
   the program that made them, beside the request's `host_reads` and its
   phases (the request's top-level spans and their children);
3. the clock mapping: the next request under torch.profiler (CPU and CUDA
   activity) with `annotate(True)`: how far each `mm.<span>` range starts
   from its span's start mapped by `to_profiler_ns`, and how many `mm.*`
   ranges the profiler also shows on the device.

Prints one JSON document and writes it to --out.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import timeit
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmark"))
sys.path.insert(1, ROOT)


def host_cost():
    from model_matching_tpu_torch.utils import trace

    out = {}
    for on in (True, False):
        rec = trace.Recorder(on=on)

        def one():
            with rec.span("x"):
                pass

        def inc():
            rec.count("c")

        n = 100_000
        key = "on" if on else "off"
        out[f"span_us_{key}"] = min(timeit.repeat(one, number=n, repeat=7)) / n * 1e6
        out[f"count_us_{key}"] = min(timeit.repeat(inc, number=n, repeat=7)) / n * 1e6
    return out


def _port_frame(w):
    """file:line of a warning, the path taken from the repository root."""
    path = os.path.relpath(w.filename, ROOT) if w.filename.startswith(ROOT) else w.filename
    return f"{path}:{w.lineno}"


def one_cell(cell, seed, device, scale):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import loops
    import run
    from model_matching_tpu_torch.utils import trace

    spec = run.load_spec(cell)
    session = loops.Session(spec, seed, device, scale)
    card = session.dev.type == "cuda"
    try:
        session.setup()
        i = spec["cell"]["warmup_requests"]
        mark, before = trace.mark(), trace.counters()
        if card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                rec = session.request(i)
        finally:
            if card:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
        after = trace.counters()
        entries = trace.snapshot(mark).entries
        n_sync_spans = sum(1 for e in entries if e.kind == "span" and e.name in (
            "estimate.sample", "estimate.congruent", "estimate.fit", "estimate.score"))
        sites = collections.Counter(_port_frame(w) for w in syncs)
        out = {
            "request_ms": (rec.t1 - rec.t0) * 1e3,
            "ok": rec.ok,
            "implicit_syncs": len(syncs),
            "sync_sites": dict(sites.most_common(25)),
            "explicit_syncs_in_spans": n_sync_spans,
            "counters": {k: v - before.get(k, 0) for k, v in after.items()
                         if v != before.get(k, 0)},
            "phases_ms": {k: round(v, 3) for k, v in trace.phases_ms(entries).items()},
        }

        mark = trace.mark()
        trace.annotate(True)
        try:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
            with profile(activities=acts) as prof:
                session.request(i + 1)
                session.sync()
        finally:
            trace.annotate(False)
        spans = collections.defaultdict(list)
        for e in trace.snapshot(mark).entries:
            if e.kind == "span":
                spans[e.name].append(e)
        host_ev = collections.defaultdict(list)
        on_device = 0
        for ev in prof.profiler.kineto_results.events():
            if not ev.name().startswith("mm."):
                continue
            if ev.device_type() == DeviceType.CUDA:
                on_device += 1
            else:
                host_ev[ev.name()[3:]].append(ev)
        gaps = []
        for name, evs in host_ev.items():
            for ev, s in zip(sorted(evs, key=lambda e: e.start_ns()),
                             sorted(spans[name], key=lambda e: e.t0)):
                gaps.append(ev.start_ns() - trace.to_profiler_ns(s.t0))
        now_epoch = time.time_ns()
        out["clock"] = {
            "mm_ranges_on_host": sum(len(v) for v in host_ev.values()),
            "mm_ranges_on_device": on_device,
            "spans": sum(len(v) for v in spans.values()),
            "start_gap_us_min": min(gaps) / 1e3 if gaps else None,
            "start_gap_us_max": max(gaps) / 1e3 if gaps else None,
            "start_gap_us_median": sorted(gaps)[len(gaps) // 2] / 1e3 if gaps else None,
            "profiler_start_s_before_now": (
                (now_epoch - min(e.start_ns() for v in host_ev.values() for e in v)) / 1e9
                if host_ev else None),
        }
        return out
    finally:
        session.close()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cells", default="ycb.serve,packed.serve")
    p.add_argument("--seed", type=int, default=2**31 + 11)
    p.add_argument("--out", default=os.path.join(ROOT, "build", "trace_cost.json"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--scale", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    doc = {"device": name, "torch": torch.__version__, "host": host_cost(), "cells": {}}
    for cell in args.cells.split(","):
        doc["cells"][cell] = one_cell(cell, args.seed, args.device, args.scale)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
