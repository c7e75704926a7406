"""The LF-walk kernel's share of its roofline: the least time of the
first call's walk (``bound_ms``) over that call's device time by name
in the profiler (``sa_walk_kernel``).

The work is counted by the reference over its own index, on the ranks
the port handed to its first call (the probe wraps
``fm_cuda.sa_walk_cuda``), never from the port's counters: the lanes
(ranks >= 0), the exact LF steps, the longest walk and the distinct
checkpoint rows the steps read (``count_walk``).

The bound is the largest of three times:

- HBM: the ranks read and the positions written once, 16 bytes an
  entry, plus the rows touched beyond what L2 holds (the first reads of
  a table larger than L2 come from HBM), at 3.35 TB/s
  (``roofline.HBM_BYTES_PER_S``);
- L2: two 32-byte sectors a step (a 48- or 64-byte row spans two), one
  a lane's SA sample and the HBM stream, which passes through L2, at
  ``L2_BYTES_PER_S``;
- latency: the longest walk's steps, one dependent load each, at
  ``LOAD_NS``.

The constants were measured on an H100 80GB HBM3 at 700 W by
``chip_smoke.py``'s walk phase, over a 3.5 MB table of rows that sits in
L2: L2's read bandwidth 7.32-7.45 TB/s (``l2_bytes_per_s``, the highest
kept, so that the bound is never too large) and 148.3 ns a dependent
load (``dependent_load_ns``, K2's chase).  A row read from HBM takes
longer, so on an index larger than L2 the latency term is low, never
high.  L2 is the H100 SXM's 50 MiB.  The three terms and the one that
bounds the call go to standard error."""

from __future__ import annotations

import contextlib
import sys
import time

import torch

from .. import roofline
from ..reference.bwamem.ops.fm import DeviceFMIndex, _lf
from ._wrap import patched

KERNEL = "sa_walk_kernel"
L2_BYTES = 50 * 2**20
L2_BYTES_PER_S = 7.45e12
LOAD_NS = 148.3


class Probe:
    def __init__(self):
        self.first = None       # (sa_intv, ranks) of the first call
        self.n = 0


@contextlib.contextmanager
def probe(cell):
    import seqlib_tpu_torch.ops.fm_cuda as fc
    p = Probe()

    def make(orig):
        def rec(fm, ranks, *a, **kw):
            out = orig(fm, ranks, *a, **kw)
            if p.first is None:
                p.first = (fm.sa_intv, ranks)
            p.n += 1
            return out
        return rec

    with patched(fc, "sa_walk_cuda", make):
        yield p


def count_walk(fm, ranks, intv: int) -> dict:
    """What the walk of ``ranks`` needs on the reference's index ``fm``
    (sampled every ``intv`` ranks, capped at 64 x ``intv`` steps, as the
    kernel walks): entries, lanes, steps, the longest walk, and the
    distinct checkpoint rows the steps read."""
    flat = ranks.reshape(-1).to(fm.blocks.device)
    live = flat[flat >= 0]
    lanes = live.numel()
    touched = torch.zeros(fm.blocks.shape[0], dtype=torch.bool,
                          device=fm.blocks.device)
    steps = longest = 0
    live = live[(live % intv != 0) & (live != fm.primary)]
    while live.numel() and longest < 64 * intv:
        touched[(live - (live > fm.primary).long()) >> 7] = True
        live = _lf(fm, live)
        steps += live.numel()
        longest += 1
        live = live[(live % intv != 0) & (live != fm.primary)]
    return dict(entries=flat.numel(), lanes=lanes, steps=steps,
                longest=longest, rows=int(touched.sum()))


def bound_ms(entries: int, lanes: int, steps: int, longest: int, rows: int,
             row_bytes: int) -> tuple[float, str, dict]:
    """(the least ms of one walk, the term that sets it, every term's ms)
    for the counts of ``count_walk`` on rows of ``row_bytes``."""
    stream = 16 * entries
    beyond = max(rows * row_bytes - L2_BYTES, 0)
    terms = {"HBM": 1e3 * (stream + beyond) / roofline.HBM_BYTES_PER_S,
             "L2": 1e3 * (64 * steps + 32 * lanes + stream) / L2_BYTES_PER_S,
             "latency": 1e-6 * longest * LOAD_NS}
    by = max(terms, key=terms.get)
    return terms[by], by, terms


def read(ctx):
    p = ctx.probes["walk_roofline"]
    ev = ctx.trace.named(KERNEL)
    if p.first is None or len(ev) != p.n:
        print(f"walk_roofline: {p.n} calls, {len(ev)} {KERNEL} events: not "
              "matched", file=sys.stderr)
        return None
    t0 = time.perf_counter()
    intv, ranks = p.first
    fm = DeviceFMIndex.from_host(ctx.cell.reference(), device=ranks.device)
    work = count_walk(fm, ranks, intv)
    row_bytes = fm.blocks.shape[1] * fm.blocks.element_size()
    bound, by, terms = bound_ms(row_bytes=row_bytes, **work)
    dev_ms = (ev[0][2] - ev[0][1]) / 1e3
    print(f"walk_roofline: first of {p.n} calls, {work['entries']} entries, "
          f"{work['lanes']} lanes, {work['steps']} LF steps, the longest "
          f"{work['longest']}, {work['rows']} of {fm.blocks.shape[0]} rows "
          f"of {row_bytes} B touched; bound {bound:.4f} ms by {by} ("
          + ", ".join(f"{k} {v:.4f}" for k, v in terms.items())
          + f" ms), device {dev_ms:.4f} ms; counted in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 100.0 * bound / dev_ms
