"""The readers of the port's tracer (``metrics/_spans.py`` and the eight
metrics on it) on a synthetic traced pass: a device trace and a span
list whose idle gaps and spans are known, so each value is known."""

from dataclasses import dataclass, field

import pytest

from portbench import harness
from portbench.metrics import _spans
from portbench.trace import Trace
from seqlib_tpu_torch import profiling

T0 = 1_700_000_000_000_000_000     # ns on the Unix epoch, as both clocks
MAIN, WORKER = 11, 12


@dataclass
class S:
    id: int
    name: str
    start: float                    # ms after T0
    end: float
    parent: int | None = None
    thread: int = MAIN
    batch: int = 1
    attrs: dict = field(default_factory=dict)

    @property
    def start_ns(self):
        return T0 + int(self.start * 1e6)

    @property
    def end_ns(self):
        return T0 + int(self.end * 1e6)

    @property
    def ms(self):
        return (self.end_ns - self.start_ns) / 1e6


SPANS = [
    S(1, "stream.batch", 0, 60),
    S(2, "stream.read", 0, 5, 1),
    S(3, "stream.encode", 5, 10, 1),
    S(4, "align.full", 10, 60, 1),
    S(5, "seed", 10, 30, 4, attrs={"stream_ms": 7.5}),
    S(6, "locate", 30, 40, 4, attrs={"stream_ms": 4.0}),
    S(7, "sync.locate.keep", 32, 34, 6),
    S(8, "global_dp", 40, 60, 4, attrs={"stream_ms": 3.25}),
    S(9, "sync.global_dp.rows", 45, 60, 8),
    S(10, "stream.wait", 60, 80),
    S(11, "stream.caller", 80, 85),
    S(12, "stream.finish", 60, 95, thread=WORKER),
    S(13, "finish.fetch", 60, 75, 12, thread=WORKER),
    S(14, "finish.cols", 75, 88, 12, thread=WORKER),
    S(15, "finish.encode", 88, 95, 12, thread=WORKER),
]
COUNTERS = {"sync.locate.keep": 6, "sync.global_dp.rows": 1,
            "upload.reads": 1, "locate.lanes": 40, "locate.rounds": 3,
            "global_dp.rows": 20, "traceback.steps": 16, "extend.rows": 25}
# device events in microseconds: idle gaps [4, 12], [20, 22], [28, 90] ms
DEVICE_MS = [(2, 4), (12, 20), (22, 28), (90, 95)]
WINDOW_S = 0.1


def _trace():
    ev = [("k", T0 / 1e3 + a * 1e3, T0 / 1e3 + b * 1e3)
          for a, b in DEVICE_MS]
    busy = sum(b - a for a, b in DEVICE_MS) / 1e3
    return Trace(events=ev, busy_s=busy, window_s=WINDOW_S)


@pytest.fixture
def ctx(monkeypatch):
    monkeypatch.setattr(profiling, "take", lambda: profiling.Records(
        list(SPANS), dict(COUNTERS)))
    return harness.Ctx(cell=None, trace=_trace(), batches=1, probes={})


@pytest.mark.parametrize("name,want", [
    ("dispatch_ms_per_batch", 50.0),
    ("host_syncs_per_batch", 7.0),
    ("locate_stream_ms_per_batch", 4.0),
    ("global_dp_stream_ms_per_batch", 3.25),
    ("finish_host_ms_per_batch", 20.0),
    # dispatch: 10-12, 20-22, 28-60 ms; wait: 60-80; prep: 4-5 (read),
    # 5-10 (encode), 80-85 (caller); unattributed 85-90
    ("idle_dispatch_pct.align", 36.0),
    ("idle_wait_pct.align", 20.0),
    ("idle_prep_pct.align", 11.0),
])
def test_reader_value(ctx, name, want):
    # device events in float microseconds since 1970 resolve ~0.25 us
    mod = harness.metric_module(name)
    assert mod.read(ctx) == pytest.approx(want, abs=1e-3)


def test_idle_split_adds_up():
    t = _trace()
    split = _spans.idle_split(t.events, SPANS)
    assert split["total"] == pytest.approx(72_000)
    assert split["unattributed"] == pytest.approx(5_000)
    assert sum(split[k] for k in ("dispatch", "wait", "prep",
                                  "unattributed")) \
        == pytest.approx(split["total"])
    # the idle between the first and the last device event, and the idle
    # share of the whole window less what lies outside those events
    first, last = DEVICE_MS[0][0], DEVICE_MS[-1][1]
    assert split["total"] / 1e3 == pytest.approx(
        (last - first) - (t.busy_s * 1e3))


def test_longest_gaps_are_named(ctx, capsys):
    gaps = _spans.longest_gaps(_trace().events, SPANS)
    assert gaps[0] == (pytest.approx(0.062), "sync.global_dp.rows",
                       "global_dp", "sync.global_dp.rows")
    assert gaps[1][1:] == ("stream.encode", "-", "-")
    assert [round(g[0], 6) for g in gaps] == [0.062, 0.008, 0.002]
    harness.metric_module("idle_wait_pct.align").read(ctx)
    harness.metric_module("idle_prep_pct.align").read(ctx)
    err = capsys.readouterr().err
    assert err.count("idle split") == 1 and "unattributed 0.0050 s" in err
    assert err.count("idle gap") == 3


def test_counters_print_per_batch(ctx, capsys):
    harness.metric_module("locate_stream_ms_per_batch").read(ctx)
    harness.metric_module("global_dp_stream_ms_per_batch").read(ctx)
    err = capsys.readouterr().err
    assert "locate.lanes 40, locate.rounds 3" in err
    assert "extend.rows 25, global_dp.rows 20, traceback.steps 16" in err


def test_a_program_without_the_tracer_gives_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "take")
    monkeypatch.delattr(profiling, "tracing")
    c = harness.Ctx(cell=None, trace=_trace(), batches=1, probes={})
    with _spans.probe(None) as p:
        assert p is None
    for name in ("dispatch_ms_per_batch", "host_syncs_per_batch",
                 "finish_host_ms_per_batch", "idle_dispatch_pct.align"):
        assert harness.metric_module(name).read(c) is None


def test_probe_turns_the_tracer_on():
    assert not profiling.enabled()
    with _spans.probe(None), _spans.probe(None):
        assert profiling.enabled()
    assert not profiling.enabled()
