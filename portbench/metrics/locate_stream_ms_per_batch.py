"""Device ms a batch in the SA locate (``sa_lookup``: a gather on a full
SA, the LF walk on a loaded index): the ``stream_ms`` of the port
tracer's ``locate`` span, from CUDA events recorded on the stream at its
start and end and read after the batch's outputs reached the host (no
synchronise).  On the stream's time it holds the device's idle time
between the walk's launches too.  The ``locate.*`` counters (lanes,
rounds, lane steps) a batch go to standard error."""

from __future__ import annotations

from . import _spans

probe = _spans.probe


def read(ctx):
    v = _spans.per_batch(ctx, "locate")
    if v is not None:
        rec = _spans.records(ctx)
        _spans.log("locate_stream_ms_per_batch counters a batch: "
                   + _spans.counters_line(rec, ("locate.",),
                                          _spans.batches(rec.spans)))
    return v
