"""What the readers of the port's own tracer share.

``probe(cell)`` turns the tracer of ``seqlib_tpu_torch.profiling`` on for
the traced pass (the pass under the profiler: these probes do not
synchronise); ``records(ctx)`` drains what it recorded there, once for
every reader of the pass.  A program without the tracer gives nothing
to read, and every reader then returns None.

Spans are stamped with ``time.time_ns()``, the clock on which
torch.profiler stamps the device events of ``ctx.trace`` (microseconds
there), so the two are laid over each other as they are.
``idle_split`` puts each idle gap of the device, between its first and
last event, down to what the stream's dispatching thread (the thread of
the ``stream.batch`` spans) was inside then: ``align.full`` (dispatch),
``stream.wait`` (wait), ``stream.read``, ``stream.encode`` or
``stream.caller`` (prep), or none of them (unattributed).

The tracer itself: ``with profiling.tracing(): ...`` turns it on
(entries nest and are counted) and ``profiling.take()`` drains what it
recorded, as ``Records(spans, counters)``.  A span has a name,
``start_ns`` and ``end_ns`` from ``time.time_ns()``, the native id of
its thread, its parent's id, a batch id shared by every span of one
stream batch, and ``attrs`` (the stage spans of ``align_full`` carry
``stream_ms``, their device time from CUDA events).  While on, each span
is also a ``record_function`` range, so the profiler's trace and
``breakdown.idle_gaps`` name it."""

from __future__ import annotations

import bisect
import contextlib
import sys

from ..trace import _union

CATEGORIES = {"align.full": "dispatch", "stream.wait": "wait",
              "stream.read": "prep", "stream.encode": "prep",
              "stream.caller": "prep"}
STAGES = ("seed", "locate", "chain", "extend", "dedup_mark", "global_dp",
          "pack")
TOP = 10


def _profiling():
    from seqlib_tpu_torch import profiling
    return profiling


@contextlib.contextmanager
def probe(cell):
    tracing = getattr(_profiling(), "tracing", None)
    with (tracing() if tracing is not None else contextlib.nullcontext()):
        yield None


class _Pass:
    """The records of one traced pass, and what was printed of them."""

    def __init__(self, ctx, rec):
        self.ctx, self.rec, self.printed = ctx, rec, set()


_last: _Pass | None = None


def _pass(ctx) -> _Pass:
    global _last
    if _last is None or _last.ctx is not ctx:
        take = getattr(_profiling(), "take", None)
        rec = take() if take is not None else None
        _last = _Pass(ctx, rec if rec is not None and rec.spans else None)
    return _last


def records(ctx):
    """(spans, counters) of the traced pass, or None where the program
    recorded no span."""
    return _pass(ctx).rec


def once(ctx, key: str) -> bool:
    """True the first time ``key`` is asked for in this pass: a line
    that several readers could print is printed by the first."""
    p = _pass(ctx)
    if key in p.printed:
        return False
    p.printed.add(key)
    return True


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def dispatching(spans) -> list:
    """The spans of the dispatching thread (that of ``stream.batch``)."""
    threads = {s.thread for s in spans if s.name == "stream.batch"}
    return [s for s in spans if s.thread in threads]


def batches(spans) -> int:
    """The batches the stream dispatched: its ``align.full`` spans."""
    return sum(1 for s in dispatching(spans) if s.name == "align.full")


def per_batch(ctx, name: str):
    """The mean over batches of the ``stream_ms`` (device time from the
    span's CUDA events) of the stage spans ``name``, or None."""
    rec = records(ctx)
    if rec is None:
        return None
    ms = [s.attrs["stream_ms"] for s in rec.spans
          if s.name == name and "stream_ms" in s.attrs]
    n = batches(rec.spans)
    return sum(ms) / n if ms and n else None


def counters_line(rec, prefixes, n: int) -> str:
    """The counters whose names start with ``prefixes``, a batch."""
    return ", ".join(f"{k} {v / n:g}" for k, v in sorted(rec.counters.items())
                     if k.startswith(prefixes)) or "none"


def _merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_split(events, spans) -> dict:
    """Device-idle microseconds between the first and last device event
    (``events``: (name, start_us, end_us) in start order), split by what
    the dispatching thread was inside: {"dispatch", "wait", "prep",
    "unattributed", "total"}."""
    _, gaps = _union(events)
    starts = [a for a, _ in gaps]
    out = dict(dispatch=0.0, wait=0.0, prep=0.0)
    by_cat: dict[str, list] = {}
    for s in dispatching(spans):
        cat = CATEGORIES.get(s.name)
        if cat is not None:
            by_cat.setdefault(cat, []).append((s.start_ns / 1e3,
                                               s.end_ns / 1e3))
    for cat, ivs in by_cat.items():
        for a, b in _merged(ivs):
            k = max(bisect.bisect_right(starts, a) - 1, 0)
            while k < len(gaps) and gaps[k][0] < b:
                lo, hi = max(gaps[k][0], a), min(gaps[k][1], b)
                if hi > lo:
                    out[cat] += hi - lo
                k += 1
    out["total"] = sum(b - a for a, b in gaps)
    out["unattributed"] = max(out["total"] - out["dispatch"] - out["wait"]
                              - out["prep"], 0.0)
    return out


def longest_gaps(events, spans, top: int = TOP) -> list:
    """The ``top`` longest device-idle gaps as (seconds, the innermost
    span of the dispatching thread over the gap's middle, its stage,
    its sync or upload site)."""
    _, gaps = _union(events)
    mine = sorted(dispatching(spans), key=lambda s: s.start_ns)
    by_id = {s.id: s for s in mine}
    starts = [s.start_ns / 1e3 for s in mine]
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) / 2
        inner = None
        for s in reversed(mine[:bisect.bisect_right(starts, mid)]):
            if s.end_ns / 1e3 >= mid:
                inner = s
                break
        stage = site = "-"
        p = inner
        while p is not None:
            if p.name in STAGES and stage == "-":
                stage = p.name
            if p.name.startswith(("sync.", "upload.")) and site == "-":
                site = p.name
            p = by_id.get(p.parent)
        out.append(((b - a) / 1e6, inner.name if inner else "no span",
                    stage, site))
    return out


def idle_pct(ctx, cat: str):
    """100 x the device-idle seconds in category ``cat`` over the traced
    pass's window; the split and the longest gaps go to standard error
    once a pass."""
    rec = records(ctx)
    t = ctx.trace
    if rec is None or not t.events or t.window_s <= 0:
        return None
    split = idle_split(t.events, rec.spans)
    if once(ctx, "idle"):
        tot = split["total"] or 1.0
        log("idle split (device idle between its first and last event, "
            f"{split['total'] / 1e6:.4f} s): " + ", ".join(
                f"{k} {split[k] / 1e6:.4f} s ({100 * split[k] / tot:.1f}%)"
                for k in ("dispatch", "wait", "prep", "unattributed")))
        for sec, name, stage, site in longest_gaps(t.events, rec.spans):
            log(f"idle gap {sec:.6f} s: {name} (stage {stage}, site {site})")
    return 100.0 * split[cat] / 1e6 / t.window_s
