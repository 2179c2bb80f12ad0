"""Tracing: the program's spans, and ``profile_trace``, the twin of
:mod:`ppqsflhe_tpu.utils.profiling`'s.

:func:`span` marks a stretch of the program: its name, its parent (the
innermost span open at its entry), the round it belongs to (the count of
outermost spans, shared by every span of one call), its host stamps and,
for a device span, a pair of timing events recorded on the current stream
at entry and exit. Inside a CUDA graph's capture (:func:`capturing`, which
:class:`..utils.graphs.Graph` enters) a device span records its events into
the graph, where CUDA makes each one an event-record node; the graph keeps
those spans, and each replay queues one set of them under the round of the
span open at the replay (:func:`queue`). :func:`collect` waits for the
queued events and hands back every finished span with its device ms.
Off the card the events are host-clock stand-ins (:class:`HostEvent`).

Tracing is off unless :func:`tracing` encloses the calls. Off, :func:`span`
returns one shared no-op context: it creates no event, reads no clock and
keeps no record, and a graph captured then holds no event node.

The host stamps are on :data:`clock`, the clock of ``torch.profiler``'s
events, so an idle gap of a profile can be put down to the span the host
was in; under a running profiler each span also opens a
``record_function`` range, so the spans show in :func:`profile_trace`'s
Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import time

# the host stamps' clock: torch.profiler (kineto) stamps its events on the
# Unix clock in ns
clock = time.time_ns
LIMIT = 1 << 18     # finished spans kept until collect(); the oldest go first


@dataclasses.dataclass
class Record:
    """One span of one call. ``parent`` is the ``id`` of the span that was
    innermost open at its entry (None at the top); ``round`` is shared by
    every span of one outermost call; ``host`` is (start, end) ns on
    :data:`clock`, None for a span replayed from a graph; ``device_ms`` is
    the time between its events on the stream, None for a host span."""

    name: str
    id: int
    parent: int | None
    round: int
    host: tuple | None = None
    device_ms: float | None = None


@dataclasses.dataclass
class Captured:
    """A device span recorded into a graph during its capture: ``parent``
    is the index of its parent among the capture's spans (None: the span
    open at the replay)."""

    name: str
    index: int
    parent: int | None
    start: object
    end: object


class HostEvent:
    """A timing event off the card: the host clock at :meth:`record`."""

    t = 0

    def record(self):
        self.t = clock()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) / 1e6


class _Recorder:
    """The process's spans: whether tracing is on, the open spans, the
    captures in progress, the finished records and the event pairs that
    :func:`collect` has yet to read."""

    def __init__(self):
        self.on = False
        self.cuda = False
        self.skip = frozenset()
        self.open = []          # Record, or Captured inside a capture
        self.captures = []      # the spans of each capture in progress, innermost last
        self.records = collections.deque(maxlen=LIMIT)
        self.pending = []       # (record, start event, end event)
        self.replays = []       # the captured sets with a replay in pending
        self.ids = itertools.count()
        self.rounds = 0

    def event(self):
        if self.cuda:
            import torch

            return torch.cuda.Event(enable_timing=True, external=True)
        return HostEvent()

    def new_round(self) -> int:
        self.rounds += 1
        return self.rounds

    @contextlib.contextmanager
    def captured(self, name: str, device: bool):
        """A span inside a capture: its events become the graph's nodes."""
        if not device:
            yield
            return
        sink = self.captures[-1]
        outer = self.open[-1] if self.open else None
        parent = outer.index if any(s is outer for s in sink) else None
        c = Captured(name, len(sink), parent, self.event(), self.event())
        sink.append(c)
        c.start.record()
        self.open.append(c)
        try:
            yield
        finally:
            self.open.pop()
            c.end.record()

    @contextlib.contextmanager
    def eager(self, name: str, device: bool):
        import torch

        outer = self.open[-1] if self.open else None
        rec = Record(name, next(self.ids), outer.id if outer else None,
                     outer.round if outer else self.new_round())
        events = (self.event(), self.event()) if device else None
        ranged = (torch.profiler.record_function(name) if torch.autograd._profiler_enabled()
                  else contextlib.nullcontext())
        t0 = clock()
        if events:
            events[0].record()
        self.open.append(rec)
        try:
            with ranged:
                yield
        finally:
            self.open.pop()
            if events:
                events[1].record()
            rec.host = (t0, clock())
            self.records.append(rec)
            if events:
                self.pending.append((rec, *events))
                if len(self.pending) >= LIMIT:
                    self.resolve()

    def queue(self, spans: list) -> None:
        if any(s is spans for s in self.replays):     # its events are about to be re-recorded
            self.resolve()
        outer = self.open[-1] if self.open and isinstance(self.open[-1], Record) else None
        rnd = outer.round if outer else self.new_round()
        recs = []
        for c in spans:
            parent = recs[c.parent].id if c.parent is not None else outer.id if outer else None
            rec = Record(c.name, next(self.ids), parent, rnd)
            recs.append(rec)
            self.records.append(rec)
            self.pending.append((rec, c.start, c.end))
        self.replays.append(spans)

    def resolve(self) -> None:
        for rec, start, end in self.pending:
            end.synchronize()
            rec.device_ms = start.elapsed_time(end)
        self.pending.clear()
        self.replays.clear()


_rec = _Recorder()
_NULL = contextlib.nullcontext()


def span(name: str, device: bool = True):
    """A context marking the enclosed calls as span ``name``: a host span
    with a device span (timing events on the current stream) unless
    ``device`` is False. Off: a shared no-op context."""
    if not _rec.on or name in _rec.skip:
        return _NULL
    if _rec.captures:
        return _rec.captured(name, device)
    return _rec.eager(name, device)


@contextlib.contextmanager
def tracing(skip=()):
    """Spans are recorded for the enclosed calls (CUDA events where the
    card is there, else :class:`HostEvent` stand-ins), but those named in
    ``skip``: each device span adds two event nodes to a captured graph,
    and each holds the next kernel back a few µs."""
    import torch

    was = _rec.on, _rec.cuda, _rec.skip
    _rec.on, _rec.cuda, _rec.skip = True, torch.cuda.is_available(), frozenset(skip)
    try:
        yield
    finally:
        _rec.on, _rec.cuda, _rec.skip = was


@contextlib.contextmanager
def capturing():
    """Around a CUDA graph's capture: yields the list that collects the
    device spans opened inside (each a :class:`Captured`), empty when
    tracing is off."""
    spans = []
    if not _rec.on:
        yield spans
        return
    _rec.captures.append(spans)
    try:
        yield spans
    finally:
        _rec.captures.pop()


def queue(spans: list) -> None:
    """One replay of a graph captured with ``spans``: a record of each,
    under the round of the span open now, its events read by
    :func:`collect` (a replay's events are read before the next replay of
    the same graph records them again). Nothing while tracing is off."""
    if _rec.on:
        _rec.queue(spans)


def collect() -> list:
    """Every span finished since the last call (at most :data:`LIMIT`),
    each queued event pair waited for and read into ``device_ms``."""
    _rec.resolve()
    out = list(_rec.records)
    _rec.records.clear()
    return out


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into
    ``log_dir/trace_<pid>_<ns>.json``; the CUDA activities are traced when
    the card is there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
