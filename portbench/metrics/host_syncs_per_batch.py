"""Reads of a device value by the host a batch (``int``/``bool`` of a
tensor, ``nonzero``): the sum of the port tracer's ``sync.<site>``
counters over the traced pass's batches.  Each makes the dispatching
thread wait for the device to drain, then launch into an idle device.
The count by site, and the blocking copies to the device
(``upload.<site>``), go to standard error."""

from __future__ import annotations

from . import _spans

probe = _spans.probe


def read(ctx):
    rec = _spans.records(ctx)
    n = _spans.batches(rec.spans) if rec is not None else 0
    if not n:
        return None
    _spans.log(f"host_syncs_per_batch by site: "
               f"{_spans.counters_line(rec, ('sync.', 'upload.'), n)}")
    return sum(v for k, v in rec.counters.items()
               if k.startswith("sync.")) / n
