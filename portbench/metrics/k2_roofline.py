"""Kernel K2's share of its roofline: the least time of the
bi-extensions and rank words that the first ``KEEP`` calls' reads need
(``roofline.k2_bound_ms``; the work is counted by the reference's plain
SMEM machine on the same reads over the reference's own index) over
those calls' device time by name in the profiler
(``smem_warp_kernel``, in start order)."""

from __future__ import annotations

import contextlib
import sys
import time

from .. import roofline
from ..reference.bwamem.ops.fm import DeviceFMIndex, _smem_machine
from ._wrap import patched

KERNEL = "smem_warp_kernel"
KEEP = 2
NAMES = ("reads", "lens", "x0", "min_intv", "active", "max_seeds",
         "min_seed_len", "C", "max_rounds", "step_cap", "p3_seeds",
         "p3_max_intv")


class Probe:
    def __init__(self):
        self.calls = []
        self.n = 0


@contextlib.contextmanager
def probe(cell):
    import seqlib_tpu_torch.ops.fm_cuda as fc
    p = Probe()

    def make(orig):
        def rec(fm, *a, **kw):
            out = orig(fm, *a, **kw)
            if len(p.calls) < KEEP:
                p.calls.append((fm.wide, dict(zip(NAMES, a), **kw)))
            p.n += 1
            return out
        return rec

    with patched(fc, "smem_machine_cuda", make):
        yield p


def read(ctx):
    p = ctx.probes["k2_roofline"]
    ev = ctx.trace.named(KERNEL)
    if not p.calls or len(ev) != p.n:
        print(f"k2_roofline: {p.n} calls, {len(ev)} {KERNEL} events: not "
              "matched", file=sys.stderr)
        return None
    t0 = time.perf_counter()
    dev = p.calls[0][1]["reads"].device
    fm = DeviceFMIndex.from_host(ctx.cell.reference(), device=dev,
                                 wide=p.calls[0][0])
    index_bytes = fm.blocks.numel() * fm.blocks.element_size()
    bound, by = 0.0, set()
    for wide, kw in p.calls:
        work = _smem_machine(fm, count_work=True, **kw)
        b, what = roofline.k2_bound_ms(
            index_bytes, kw["reads"], kw["max_seeds"], kw.get("p3_seeds", 0),
            wide, int(work["exts"].sum()), int(work["rank_words"].sum()))
        bound += b
        by.add(what)
    dev_ms = sum(e - s for _, s, e in ev[:len(p.calls)]) / 1e3
    print(f"k2_roofline: first {len(p.calls)} of {p.n} calls, bound "
          f"{bound:.4f} ms by {'/'.join(sorted(by))}, device {dev_ms:.3f} "
          f"ms; counted in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return 100.0 * bound / dev_ms
