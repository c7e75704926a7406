"""What a traced window's torch.profiler recording says: the device
events (kernels and copies) in start order, the seconds in which one
ran (the union of their intervals), the device operations that took
the most time, and the longest idle gaps of the device, each named by
what the dispatching host thread was doing then (its innermost
recorded operation)."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import torch

MAIN_SPAN = "portbench.window"
NAME_CHARS = 160        # a kernel's name in the breakdown, cut to this


@dataclass
class Trace:
    events: list = field(default_factory=list)   # (name, start_us, end_us)
    busy_s: float = 0.0
    window_s: float = 0.0
    device_ops: list = field(default_factory=list)   # [[name, s]]
    idle_gaps: list = field(default_factory=list)    # [[name, s]]

    def named(self, part: str) -> list:
        """Device events whose name holds ``part``, in start order."""
        return [e for e in self.events if part in e[0]]


def _union(events) -> tuple[float, list]:
    """(busy microseconds, the gaps between merged intervals as (start,
    end))."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for _, s, e in events:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def _raw(prof):
    """(device events as (name, start_us, end_us), host events as
    (start_us, end_us, thread, name)) from the profiler's own records
    (``kineto_results``: far faster to read than ``prof.events()``).  A
    ``record_function`` span is mirrored on the device as an annotation
    that covers its whole time; it is no device operation."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == cuda:
            annotation = getattr(e, "is_user_annotation", None)
            if e.name() == MAIN_SPAN or (annotation and annotation()):
                continue
            dev.append((e.name(), s, t))
        else:
            cpu.append((s, t, e.start_thread_id(), e.name()))
    return dev, cpu


def summarize(prof, window_s: float, top: int = 10) -> Trace | None:
    """The Trace of one profiled window, or None where the profiler
    recorded no device events."""
    dev, cpu = _raw(prof)
    main_thread = next((c[2] for c in cpu if c[3] == MAIN_SPAN), None)
    if not dev:
        return None
    dev.sort(key=lambda x: x[1])
    busy_us, gaps = _union(dev)
    by_name: dict[str, float] = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ops = [(k[:NAME_CHARS], v) for k, v in ops]
    host = sorted((c for c in cpu if c[2] == main_thread
                   and c[3] != MAIN_SPAN), key=lambda c: c[0])
    starts = [c[0] for c in host]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) / 2
        what = "host: no recorded operation"
        # the innermost operation covering the gap's middle: the latest
        # start among those that end after it
        for c in reversed(host[:bisect.bisect_right(starts, mid)]):
            if c[1] >= mid:
                what = c[3]
                break
        named.append([what[:NAME_CHARS], (b - a) / 1e6])
    return Trace(events=dev, busy_s=busy_us / 1e6, window_s=window_s,
                 device_ops=[[k, v] for k, v in ops], idle_gaps=named)
