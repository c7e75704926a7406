"""Device ms a batch in the global DP and traceback (the row compaction,
``global_batch`` and the traceback loop of ``align_full``): the
``stream_ms`` of the port tracer's ``global_dp`` span, from CUDA events
on the stream at its start and end, read after the batch's outputs
reached the host (no synchronise).  The ``global_dp.*``,
``traceback.steps`` and ``extend.*`` counters a batch go to standard
error."""

from __future__ import annotations

from . import _spans

probe = _spans.probe


def read(ctx):
    v = _spans.per_batch(ctx, "global_dp")
    if v is not None:
        rec = _spans.records(ctx)
        _spans.log("global_dp_stream_ms_per_batch counters a batch: "
                   + _spans.counters_line(
                       rec, ("global_dp.", "traceback.", "extend."),
                       _spans.batches(rec.spans)))
    return v
