"""Kernel K1's share of its roofline: the least time of the band cells
that each call's lanes need (``roofline.k1_bound_ms``; the rows each
lane runs come from the reference's plain extension on the same
inputs) over K1's device time by name in the profiler
(``band_warp_kernel``), summed over the calls of the traced pass."""

from __future__ import annotations

import contextlib
import sys

from .. import roofline
from ..reference.bwamem.ops.sw import extend_batch
from ._wrap import patched

KERNEL = "band_warp_kernel"
NAMES = ("o_del", "e_del", "o_ins", "e_ins", "match", "mismatch", "zdrop",
         "band")


class Probe:
    def __init__(self):
        self.calls = []


@contextlib.contextmanager
def probe(cell):
    import seqlib_tpu_torch.ops.sw_cuda as sc
    p = Probe()

    def make(orig):
        def rec(*a, **kw):
            out = orig(*a, **kw)
            p.calls.append((a[:5], dict(zip(NAMES, a[5:]), **kw)))
            return out
        return rec

    with patched(sc, "extend_batch_banded_cuda", make):
        yield p


def read(ctx):
    calls = ctx.probes["k1_roofline"].calls
    ev = ctx.trace.named(KERNEL)
    if not calls or len(ev) != len(calls):
        print(f"k1_roofline: {len(calls)} calls, {len(ev)} {KERNEL} "
              "events: not matched", file=sys.stderr)
        return None
    bound, by = 0.0, set()
    for args, kw in calls:
        rows = extend_batch(*args, return_rows=True, **kw)["rows"]
        b, what = roofline.k1_bound_ms(*args, kw["band"], rows)
        bound += b
        by.add(what)
    dev_ms = sum(e - s for _, s, e in ev) / 1e3
    print(f"k1_roofline: {len(calls)} calls, bound {bound:.4f} ms by "
          f"{'/'.join(sorted(by))}, device {dev_ms:.3f} ms",
          file=sys.stderr)
    return 100.0 * bound / dev_ms
