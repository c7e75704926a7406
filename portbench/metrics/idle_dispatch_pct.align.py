"""The device's idle share of the traced pass while the stream's
dispatching thread was inside ``align.full`` (issuing the device
program: launches, reads of device values, uploads): 100 x the device-
idle seconds (the gaps between the profiler's device events) that the
thread's spans cover, over the pass's wall time.  The split of the
idle time, the unattributed rest and the ten longest gaps, each named
by the innermost span with its stage and site, go to standard error
once a pass."""

from __future__ import annotations

from . import _spans

probe = _spans.probe


def read(ctx):
    return _spans.idle_pct(ctx, "dispatch")
