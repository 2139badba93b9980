"""Shared arithmetic of the readers of the program's own spans and counters
(`source: program_span`): the port's flight recorder
(model_matching_tpu_torch/utils/trace.py) keeps a bounded log of named spans
and counter increments on the host's perf_counter clock, the clock of the
window's records. A reader takes the entries whose start falls inside an
answered request of the window ([t0, t1] of a record with `ok`), and returns
None where it finds nothing to read: a program without the log, an empty
log, a log trimmed past the window's first request, or no such entry in the
window."""

from __future__ import annotations

import bisect


def program_log():
    """The program's log (a trace.Snapshot), or None where the program
    keeps none."""
    try:
        from model_matching_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def _windows(records):
    """[(t0, t1)] in ns of the window's answered requests, in order."""
    return [(round(r.t0 * 1e9), round(r.t1 * 1e9)) for r in records if r.ok]


def by_request(records, log):
    """{request index: [entries starting inside it]} over the answered
    requests of `records`, or None where the log cannot cover them."""
    wins = _windows(records)
    if log is None or not log.entries or not wins:
        return None
    if log.trimmed_at is not None and log.trimmed_at >= wins[0][0]:
        return None
    starts = [w[0] for w in wins]
    out = {i: [] for i in range(len(wins))}
    for e in log.entries:
        i = bisect.bisect_right(starts, e.t0) - 1
        if i >= 0 and e.t0 <= wins[i][1]:
            out[i].append(e)
    return out


def _spans(entries, name):
    return [e for e in entries if e.kind == "span" and e.name == name and e.t1 is not None]


def span_ms_per_request(records, log, name):
    """Mean over the answered requests of the ms of spans `name` in each."""
    req = by_request(records, log)
    if req is None:
        return None
    per = [sum(e.t1 - e.t0 for e in _spans(es, name)) for es in req.values()]
    if not any(_spans(es, name) for es in req.values()):
        return None
    return 1e-6 * sum(per) / len(per)


def span_ms_mean(records, log, name):
    """Mean ms of one span `name` over those in the answered requests."""
    req = by_request(records, log)
    if req is None:
        return None
    spans = [e for es in req.values() for e in _spans(es, name)]
    return 1e-6 * sum(e.t1 - e.t0 for e in spans) / len(spans) if spans else None


def count_total(records, log, name):
    """(sum of counter `name`'s increments in the answered requests, those
    requests), or None where nothing was counted."""
    req = by_request(records, log)
    if req is None:
        return None
    hits = [e.n for es in req.values() for e in es if e.kind == "count" and e.name == name]
    return (sum(hits), len(req)) if hits else None


def count_per_request(records, log, name):
    got = count_total(records, log, name)
    return got[0] / got[1] if got else None


def count_per_base(records, log, name):
    got = count_total(records, log, name)
    bases = sum(r.bases for r in records if r.ok)
    return got[0] / bases if got and bases else None


def untraced_ms(records, log):
    """Mean ms a request spends outside every top-level program span (one
    with no parent), the spans clipped to the request."""
    req = by_request(records, log)
    if req is None:
        return None
    wins = _windows(records)
    gaps = []
    for i, es in req.items():
        lo, hi = wins[i]
        tops = sorted((max(e.t0, lo), min(e.t1, hi)) for e in es
                      if e.kind == "span" and e.parent is None and e.t1 is not None)
        if not tops:
            return None
        covered, end = 0, lo
        for s, t in tops:
            s = max(s, end)
            if t > s:
                covered += t - s
                end = t
        gaps.append(hi - lo - covered)
    return 1e-6 * sum(gaps) / len(gaps)
