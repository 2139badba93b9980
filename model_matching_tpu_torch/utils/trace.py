"""Spans and counters of the port: an always-on flight recorder.

Every layer boundary of the port opens a named span (``span``) and every
place that makes a launch-bound path stall counts itself (``count``); both
go into one bounded in-memory log on the host clock
(``time.perf_counter_ns``). Nothing is written anywhere and no device
synchronize is added: a span costs a few host microseconds. A reader takes
the log with ``snapshot()``.

    with trace.span("scene.load"):                 # nests: parent = innermost open span
        ...
    with trace.span("estimate.sample", sync=dev) as sp:
        ...                                        # ends on a synchronize of dev
    seconds = sp.seconds
    trace.count("host_reads")                      # timestamped increment + running total
    with trace.request() as rid:                   # spans and counts carry rid
        ...

Each log entry has a number (``seq``) in the order of recording, which
trimming does not change; a span's ``parent`` is the number of the span
that was innermost on its thread when it opened (None at the top level).
The log keeps the last ``MAX_ENTRIES`` entries; ``Snapshot.trimmed_at`` is
the start of the newest entry it dropped, so a reader can tell whether a
window is complete.

``MM_TORCH_TRACE=0`` in the environment turns recording off: ``span``
returns one shared no-op context, except that a ``sync`` span still
synchronizes and a ``sync`` or ``timed`` span still measures its
``seconds``; ``count`` keeps its running totals but logs nothing.

``annotate(True)`` also wraps every span in a
``torch.profiler.record_function`` range named ``mm.<span>``, so a Chrome
trace shows the layers over the kernels; nothing sets it by default, since
a profiler also shows such a range on the device. ``to_profiler_ns`` puts
a log timestamp on the clock of the profiler's events (epoch nanoseconds).
"""

from __future__ import annotations

import bisect
import collections
import itertools
import os
import threading
import time

import torch

MAX_ENTRIES = 1 << 18

_now = time.perf_counter_ns


def _sync(dev) -> None:
    """Wait for `dev` (a torch.device, or True for the current CUDA
    device); nothing on the CPU."""
    if dev is True:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    elif dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Count(collections.namedtuple("Count", "seq name t0 n parent request")):
    """One counter increment: `n` at time `t0` (perf_counter_ns)."""
    __slots__ = ()
    kind = "count"


class Span:
    """One span: `name` from `t0` to `t1` (perf_counter_ns; `t1` is None
    while it is open). Also the context manager that ends it: `span()`
    opens it."""
    __slots__ = ("seq", "name", "t0", "t1", "parent", "request", "_stack", "_sync", "_rf")
    kind = "span"

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            _sync(self._sync)
        self.t1 = _now()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        stack = self._stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:          # an inner span left open
            stack.remove(self)
        return False

    def __repr__(self):
        return (f"Span({self.seq}, {self.name!r}, t0={self.t0}, t1={self.t1}, "
                f"parent={self.parent}, request={self.request})")


_new = object.__new__


class _Timer:
    """A span with recording off that must still sync or time itself."""
    __slots__ = ("t0", "t1", "_sync")

    def __init__(self, sync):
        self._sync = sync

    seconds = Span.seconds

    def __enter__(self):
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            _sync(self._sync)
        self.t1 = _now()
        return False


class _NoOp:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoOp()


class _Local(threading.local):
    def __init__(self):
        self.state = [[], None]      # open spans, current request id


class Snapshot(collections.namedtuple("Snapshot", "entries trimmed_at")):
    """The log's entries (Span and Count, in the order of recording) and
    the start (perf_counter_ns) of the newest entry the bound dropped, or
    None if it dropped none."""
    __slots__ = ()


class Recorder:
    """One bounded log of spans and counter increments, with running
    counter totals. The port records into the module's recorder; tests may
    make their own."""

    def __init__(self, on: bool = True, max_entries: int = MAX_ENTRIES):
        self.on = on
        self._annotate = False
        self._max = max_entries
        self._log = collections.deque(maxlen=max_entries)
        self._seq = itertools.count()
        self._requests = itertools.count(1)
        self._trimmed_at = None
        self._totals = {}
        self._local = _Local()

    def _trim(self) -> None:
        """Called before an append to a full log drops its oldest entry."""
        first = self._log[0]
        self._trimmed_at = first[2] if type(first) is tuple else first.t0

    def span(self, name: str, sync=False, timed: bool = False):
        """Context manager recording span `name`. `sync` (True for the
        current CUDA device, or a torch.device) ends it on a synchronize of
        that device (nothing on the CPU). With recording off it is a shared
        no-op unless `sync` or `timed` asks for its `seconds`."""
        sync = None if sync is False else sync
        if not self.on:
            return _NOOP if sync is None and not timed else _Timer(sync)
        # the span opens here rather than in __enter__: one call less
        s = _new(Span)
        s.name, s._sync, s.t1, s._rf = name, sync, None, None
        state = self._local.state
        s._stack = stack = state[0]
        s.parent = stack[-1].seq if stack else None
        s.request = state[1]
        s.seq = next(self._seq)
        log = self._log
        if len(log) == self._max:
            self._trim()
        log.append(s)
        stack.append(s)
        if self._annotate:
            s._rf = torch.profiler.record_function(f"mm.{name}")
            s._rf.__enter__()
        s.t0 = _now()
        return s

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to counter `name`: a timestamped entry in the log (when
        recording) and the running total."""
        totals = self._totals
        totals[name] = totals.get(name, 0) + n
        if self.on:
            state = self._local.state
            stack = state[0]
            log = self._log
            if len(log) == self._max:
                self._trim()
            # a plain tuple here (a Count is made only by snapshot)
            log.append((next(self._seq), name, _now(), n,
                        stack[-1].seq if stack else None, state[1]))

    def counters(self) -> dict:
        """Running totals of every counter since the process started."""
        return dict(self._totals)

    def total(self, name: str) -> int:
        return self._totals.get(name, 0)

    def request(self):
        """Context manager opening a new request id; spans and counts made
        inside carry it. Yields the id."""
        return _Request(self)

    def mark(self) -> int:
        """The number the next entry will get (for `snapshot(since=...)`)."""
        log = self._log
        if not log:
            return 0
        last = log[-1]
        return (last[0] if type(last) is tuple else last.seq) + 1

    def snapshot(self, since: int = 0) -> Snapshot:
        """The entries numbered `since` or later, oldest first."""
        entries = [Count._make(e) if type(e) is tuple else e for e in self._log]
        if since:
            entries = entries[bisect.bisect_left(entries, since, key=lambda e: e.seq):]
        return Snapshot(entries, self._trimmed_at)

    def annotate(self, flag: bool = True) -> None:
        """Wrap every span in a profiler range `mm.<name>` (off by
        default)."""
        self._annotate = bool(flag)


class _Request:
    __slots__ = ("_rec", "_prev", "id")

    def __init__(self, rec):
        self._rec = rec

    def __enter__(self):
        state = self._rec._local.state
        self._prev = state[1]
        self.id = state[1] = next(self._rec._requests)
        return self.id

    def __exit__(self, *exc):
        self._rec._local.state[1] = self._prev
        return False


def _clock_offset_ns() -> int:
    """time.time_ns() - time.perf_counter_ns(), from the tightest of a few
    bracketed readings."""
    best = None
    for _ in range(16):
        a = _now()
        w = time.time_ns()
        b = _now()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


_OFFSET_NS = _clock_offset_ns()


def to_profiler_ns(t: int) -> int:
    """A log timestamp (perf_counter_ns) on the clock of torch.profiler's
    events (`start_ns()` of its kineto events: epoch nanoseconds)."""
    return t + _OFFSET_NS


def phases_ms(entries, depth: int = 2) -> dict:
    """Milliseconds by span name, summed over the spans of `entries` that
    lie fewer than `depth` levels below the top (top-level spans and their
    children by default); open spans are left out."""
    level = {}
    out = {}
    for e in entries:
        if e.kind != "span":
            continue
        d = 0 if e.parent is None else level.get(e.parent, depth) + 1
        level[e.seq] = d
        if d < depth and e.t1 is not None:
            out[e.name] = out.get(e.name, 0.0) + (e.t1 - e.t0) * 1e-6
    return out


_recorder = Recorder(on=os.environ.get("MM_TORCH_TRACE", "1") != "0")
span = _recorder.span
count = _recorder.count
counters = _recorder.counters
total = _recorder.total
request = _recorder.request
mark = _recorder.mark
snapshot = _recorder.snapshot
annotate = _recorder.annotate


def recorder() -> Recorder:
    """The port's recorder."""
    return _recorder
