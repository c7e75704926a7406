"""Host ms a batch that the stream's dispatching thread spends issuing
the device program: the ``align.full`` span of the port's tracer
(around ``BWAAligner._dispatch_full`` in ``_stream``) on the host
clock, with no synchronise, over the traced pass's batches.  The device
waits on the host for whatever part of it is launch overhead or a read
of a device value (``host_syncs_per_batch``)."""

from __future__ import annotations

from . import _spans

probe = _spans.probe


def read(ctx):
    rec = _spans.records(ctx)
    if rec is None:
        return None
    ms = [s.ms for s in _spans.dispatching(rec.spans)
          if s.name == "align.full"]
    if ms and _spans.once(ctx, "stages"):
        from seqlib_tpu_torch.profiling import StageTimer
        _spans.log("host seconds by span over the traced pass (the port's "
                   "tracer):\n" + StageTimer().add(rec.spans).report())
        _spans.log("device ms a batch by stage (stream_ms): " + ", ".join(
            f"{n} {_spans.per_batch(ctx, n):.3f}" for n in
            ("align.full",) + _spans.STAGES
            if _spans.per_batch(ctx, n) is not None))
    return sum(ms) / len(ms) if ms else None
