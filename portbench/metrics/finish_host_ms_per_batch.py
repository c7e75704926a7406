"""Host ms a batch of the stream's finish without its wait for the
device: the port tracer's ``stream.finish`` span on a worker thread
less its ``finish.fetch`` children (the copies of the batch's outputs
to the host, which wait for the device), over the traced pass's
batches.  What is left is MAPQ, columns and the native BAM encoder."""

from __future__ import annotations

from . import _spans

probe = _spans.probe


def read(ctx):
    rec = _spans.records(ctx)
    if rec is None:
        return None
    fetch: dict = {}
    for s in rec.spans:
        if s.name == "finish.fetch":
            fetch[s.parent] = fetch.get(s.parent, 0.0) + s.ms
    ms = [s.ms - fetch.get(s.id, 0.0) for s in rec.spans
          if s.name == "stream.finish"]
    return sum(ms) / len(ms) if ms else None
