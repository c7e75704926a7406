"""Host ms a batch in the stream's finish step: the host clock around each
``BWAAligner._payload_batch`` call on the stream's worker threads
(fetching the batch's device outputs, MAPQ, columns and the native BAM
encoder).  It includes the wait for the batch's device work, which the
fetch synchronises on."""

from __future__ import annotations

import contextlib
import threading
import time

from ._wrap import patched


class Probe:
    def __init__(self):
        self.ms: list[float] = []
        self._lock = threading.Lock()


@contextlib.contextmanager
def probe(cell):
    p = Probe()
    aln = cell.aligner

    def make(orig):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            with p._lock:
                p.ms.append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    with patched(aln, "_payload_batch", make):
        yield p


def read(ctx):
    ms = ctx.probes["host_ms_per_batch"].ms
    return sum(ms) / len(ms) if ms else None
