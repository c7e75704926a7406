"""The port's tracer, its summary and device traces (counterpart of
seqlib_tpu/profiling.py).

The tracer is off by default.  ``with tracing(): ...`` turns it on for
the block; entries nest and are counted, so several readers may each
hold it on.  While it is off a span site (``span``, ``sync``,
``upload``) costs one test of a module global and returns a shared
no-op context, and a counter site (``count``) costs one test.

While it is on:

- a span records its name, its start and end on the profiler's clock
  (``time.time_ns()``, the Unix epoch, on which torch.profiler stamps its
  host and device events), the native id of its thread, its parent (the
  innermost span open on that thread), and a batch id that every span of
  one stream batch carries on every thread; it also opens a
  ``torch.profiler.record_function`` range of its name, so a running
  profiler and ``device_trace`` show it;
- a span given a CUDA ``device`` records a timing event on that device's
  current stream at its start and at its end.  ``device_times(batch)``,
  called once the batch's outputs have been copied to the host, stores
  the elapsed milliseconds on each such span as ``attrs["stream_ms"]``;
  no event is read before that, so timing adds no wait for the device;
- counters add up in one table under one lock;
- ``count_device`` takes counters a kernel totalled on the device: it
  copies them to pinned host memory behind a CUDA event, and
  ``device_times(batch)`` adds them once the device has passed it (no
  wait either).

Spans and counters stay in memory until ``take()`` drains them.

``StageTimer`` sums span durations by name.  ``device_trace`` records a
``torch.profiler`` trace of a block (CPU activity always, CUDA activity
where a GPU is present) as a Chrome trace, with the tracer on, and
writes the spans and counters of the block beside it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# open tracing() blocks; every site tests this and nothing else
_depth = 0
_NOOP = contextlib.nullcontext()
_LOCK = threading.Lock()
_LOCAL = threading.local()
_BATCHES = itertools.count(1)


class Span:
    """One traced interval (see the module docstring)."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "thread", "parent",
                 "batch", "attrs", "_device", "_events", "_range")

    def __init__(self, name: str, batch=None, device=None):
        self.name = name
        self.batch = batch
        self.attrs: dict = {}
        self.start_ns = self.end_ns = 0
        self._device = device if device is not None \
            and getattr(device, "type", None) == "cuda" else None
        self._events = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_TRACER.ids)
        self.parent = up.id if up is not None else None
        if self.batch is None and up is not None:
            self.batch = up.batch
        self.thread = threading.get_native_id()
        stack.append(self)
        if self._device is not None:
            self._events = _record_event(self._device), None
        self.start_ns = time.time_ns()
        self._range = record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(None, None, None)
        self._range = None
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events = self._events[0], _record_event(self._device)
            with _LOCK:
                _TRACER.pending.append(self)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:         # closed on another path than it opened
            stack.remove(self)
        _TRACER.spans.append(self)
        return False

    def as_dict(self) -> dict:
        return dict(id=self.id, name=self.name, start_ns=self.start_ns,
                    end_ns=self.end_ns, thread=self.thread,
                    parent=self.parent, batch=self.batch, **self.attrs)


class Records(NamedTuple):
    """What ``take()`` drains: spans in the order they closed, and the
    counters by name."""
    spans: list
    counters: dict


class _Tracer:
    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self.pending: list[Span] = []    # spans whose events are unread
        # (batch, names, pinned host copy, event) of device counters
        self.pending_counts: list[tuple] = []
        self.ids = itertools.count(1)


_TRACER = _Tracer()


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def _record_event(device):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


@contextlib.contextmanager
def tracing():
    """Turn the tracer on for the block (entries nest and are counted)."""
    global _depth
    with _LOCK:
        _depth += 1
    try:
        yield
    finally:
        with _LOCK:
            _depth -= 1


def enabled() -> bool:
    return _depth > 0


def span(name: str, batch=None, device=None):
    """A span ``name`` around the block while tracing is on.  ``batch``
    sets its batch id (else the parent's); ``device``, a CUDA device,
    times the block on that device's current stream."""
    if not _depth:
        return _NOOP
    return Span(name, batch, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on.  ``n`` must be a
    value the host already holds: never a read of a device tensor."""
    if not _depth:
        return
    _add([(name, n)])


def _add(items) -> None:
    with _LOCK:
        for name, n in items:
            _TRACER.counters[name] = _TRACER.counters.get(name, 0) + int(n)


def count_device(names, values: torch.Tensor) -> None:
    """Add the integer tensor ``values`` (one value per name of
    ``names``) to those counters while tracing is on, without a host
    read: a CUDA tensor is copied to pinned host memory behind an event
    on its device's current stream, and ``device_times`` of the
    innermost open span's batch (or ``take``) adds it once the device
    has passed that event.  A CPU tensor is added at once."""
    if not _depth:
        return
    if not values.is_cuda:
        _add(zip(names, values.tolist()))
        return
    host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
    host.copy_(values, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(values.device))
    stack = _stack()
    batch = stack[-1].batch if stack else None
    with _LOCK:
        _TRACER.pending_counts.append((batch, tuple(names), host, ev))


def _site(kind: str, site: str):
    if not _depth:
        return _NOOP
    name = f"{kind}.{site}"
    count(name)
    return Span(name)


def sync(site: str):
    """Span and counter ``sync.<site>`` around one read of a device value
    by the host (``int``/``bool`` of a tensor, ``nonzero``): the host
    waits there for the device."""
    return _site("sync", site)


def upload(site: str):
    """Span and counter ``upload.<site>`` around one blocking copy from
    the host to the device, which also waits for the device's stream."""
    return _site("upload", site)


def new_batch() -> int:
    """A fresh batch id."""
    return next(_BATCHES)


def device_times(batch) -> None:
    """Store ``attrs["stream_ms"]`` on the timed spans of ``batch`` whose
    end event the device has passed, and add the device counters of
    ``batch`` whose event it has passed (no wait); a counter it has not
    passed stays for a later call or ``take``.  Call it where the
    batch's outputs have been copied to the host."""
    if not _TRACER.pending and not _TRACER.pending_counts:
        return
    with _LOCK:
        mine = [s for s in _TRACER.pending if s.batch == batch]
        _TRACER.pending = [s for s in _TRACER.pending if s.batch != batch]
        counts = [c for c in _TRACER.pending_counts if c[0] == batch]
        _TRACER.pending_counts = [c for c in _TRACER.pending_counts
                                  if c[0] != batch]
    _read_events(mine)
    late = _read_counts(counts)
    if late:
        with _LOCK:
            _TRACER.pending_counts.extend(late)


def _read_events(spans) -> None:
    for s in spans:
        start, end = s._events
        if end.query():
            s.attrs["stream_ms"] = start.elapsed_time(end)
        s._events = None


def _read_counts(counts) -> list:
    """Add the device counters whose event has passed; returns the
    others."""
    late = []
    for c in counts:
        _, names, host, ev = c
        if ev.query():
            _add(zip(names, host.tolist()))
        else:
            late.append(c)
    return late


def take() -> Records:
    """Drain the spans and counters recorded so far.  Timed spans whose
    events are still unread are read now where the device has passed
    them, and so are device counters; those it has not passed are
    dropped."""
    with _LOCK:
        pending, _TRACER.pending = _TRACER.pending, []
        counts, _TRACER.pending_counts = _TRACER.pending_counts, []
    _read_events(pending)
    _read_counts(counts)
    with _LOCK:
        spans, _TRACER.spans = _TRACER.spans, []
        counters, _TRACER.counters = _TRACER.counters, {}
    return Records(spans, counters)


class StageTimer:
    """Host wall time and counts per named stage: the tracer's summary.

    ``stage(name)`` times a block on the host clock (and is a span of the
    tracer while it is on); ``add(spans)`` adds the durations of spans
    that ``take()`` returned.  Around device work that nothing waits for,
    a host duration is the time to enqueue the work, not the device's
    time: a span's ``attrs["stream_ms"]`` is that."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add(self, spans) -> "StageTimer":
        for s in spans:
            self.totals[s.name] += (s.end_ns - s.start_ns) / 1e9
            self.counts[s.name] += 1
        return self

    def report(self) -> str:
        lines = []
        total = sum(self.totals.values()) or 1e-12
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:24s} {t:8.3f}s {t / total * 100:5.1f}% "
                         f"(n={self.counts[name]})")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a torch.profiler trace of the enclosed block, with the
    tracer on, into ``logdir``/trace_<pid>_<ns>.json (Chrome trace
    format), and the block's spans and counters, where it recorded any,
    into ``logdir``/spans_<pid>_<ns>.json.  The spans are drained
    (``take()``)."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tracing(), profile(activities=acts) as prof:
        yield prof
    stamp = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{stamp}.json"))
    rec = take()
    if rec.spans or rec.counters:
        with open(os.path.join(logdir, f"spans_{stamp}.json"), "w") as fh:
            json.dump(dict(spans=[s.as_dict() for s in rec.spans],
                           counters=rec.counters), fh)
