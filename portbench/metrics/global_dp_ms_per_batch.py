"""Synchronised host ms a batch in the global DP + traceback
(``seqlib_tpu_torch.align.device_full.global_and_traceback``, the plain
PyTorch banded DP that the fused program runs on every region kept),
over the batches of a pass of its own (synchronising removes overlap).

The work its calls needed, the band cells of each call's (qlen, tlen,
band), and the least time for it (``roofline.global_dp_bound_ms``: 8
int32 instructions and one direction byte a cell) go on an earlier line
of standard error.  They are not a share of the roofline: the host's
clock around a call of ~35 launched operations a query row measures the
launches as much as the card."""

from __future__ import annotations

import contextlib
import sys
import time

from .. import roofline
from ._wrap import patched, sync

SYNC = True


class Probe:
    def __init__(self):
        self.ms = 0.0
        self.bound_ms = 0.0
        self.by = set()


@contextlib.contextmanager
def probe(cell):
    import seqlib_tpu_torch.align.device_full as df
    p = Probe()

    def make(orig):
        def timed(q, ql, t, tl, *a, band: int = 208, **kw):
            sync(q)
            t0 = time.perf_counter()
            out = orig(q, ql, t, tl, *a, band=band, **kw)
            sync(q)
            p.ms += 1e3 * (time.perf_counter() - t0)
            b, by = roofline.global_dp_bound_ms(q, t, ql, tl, band)
            p.bound_ms += b
            p.by.add(by)
            return out
        return timed

    with patched(df, "global_and_traceback", make):
        yield p


def read(ctx):
    p = ctx.probes["global_dp_ms_per_batch"]
    if p.ms <= 0:
        return None
    print(f"global_dp_ms_per_batch: {p.ms:.1f} ms synchronised over "
          f"{ctx.batches} batches; least time of its band cells "
          f"{p.bound_ms:.4f} ms by {'/'.join(sorted(p.by))}",
          file=sys.stderr)
    return p.ms / ctx.batches
