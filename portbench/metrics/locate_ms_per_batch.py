"""Synchronised host ms a batch in the SA locate
(``seqlib_tpu_torch.align.device_pipeline.sa_lookup``: one gather on a
full SA, the LF walk to a sample on a loaded index), over the batches of
a pass of its own (synchronising removes overlap)."""

from __future__ import annotations

import contextlib
import time


from ._wrap import patched, sync

SYNC = True


class Probe:
    def __init__(self):
        self.ms: list[float] = []


@contextlib.contextmanager
def probe(cell):
    import seqlib_tpu_torch.align.device_pipeline as dp
    p = Probe()

    def make(orig):
        def timed(fm, ranks, *a, **kw):
            sync(ranks)
            t0 = time.perf_counter()
            out = orig(fm, ranks, *a, **kw)
            sync(ranks)
            p.ms.append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    with patched(dp, "sa_lookup", make):
        yield p


def read(ctx):
    p = ctx.probes["locate_ms_per_batch"]
    return sum(p.ms) / ctx.batches if p.ms else None
