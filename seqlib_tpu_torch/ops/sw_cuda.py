"""Kernels K1 and K3: banded and full-rectangle seed extension on CUDA,
and the adaptive-band wrapper around K1 (counterpart of
seqlib_tpu/ops/sw_pallas.py).

``extend_batch_banded`` launches ``csrc/sw_extend.cu`` on CUDA tensors
and runs the plain version ``ops.sw.extend_batch(band=...)`` on CPU
tensors.  ``extend_batch_adaptive`` is the production extension: a
narrow first pass, a provably safe acceptance test, and a full-band
rerun of the rest; it equals ``extend_batch(band=band)``.
``extend_batch_rect`` (the counterpart of ``extend_batch_pallas``)
launches K3 from ``csrc/sw_rect.cu`` on CUDA tensors and runs
``ops.sw.extend_rect`` on CPU tensors; ``launch_rect`` is the launcher
shared with K4 and K5 (``ops.sw_variants``).

``global_traceback_cuda`` launches ``csrc/global_dp.cu``: the banded
global DP and its traceback in one launch, which hands over each row's
CIGAR runs, then one launch that gathers the runs into one flat array;
what ``align.device_pipeline.global_and_traceback`` runs on CUDA tensors
(the plain route, ``global_batch`` and the torch walk, runs on CPU
tensors).  It replaces no TPU kernel: the JAX package runs that stage in
XLA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import profiling
from . import cuda_lib
from .sw import RECT_MAX_LT, check_rect_shape, extend_batch, extend_rect

KERNEL = "sw_extend"
RECT_LIB = "sw_rect"
GLOBAL = "global_dp"
GATHER = "global_dp_gather"
# the tracer's counters of one global DP call, in the kernel's totals order
GLOBAL_COUNTERS = ("global_dp.dp_rows_run", "traceback.steps",
                   "traceback.runs")

# which branch each adaptive call took (tests check all three run); moved
# under cuda_lib's counters' lock
ADAPTIVE_BRANCHES = {"narrow_only": 0, "compact_rerun": 0, "full_rerun": 0,
                     "full_band": 0}


def _lane_args(name: str, dev, M: int, *values):
    """Per-lane inputs as contiguous int32 tensors of shape (M,) on dev."""
    out = []
    for v in values:
        v = torch.as_tensor(v, device=dev)
        if v.shape != (M,):
            raise ValueError(f"{name}: per-lane input of shape "
                             f"{tuple(v.shape)}, expected ({M},)")
        out.append(v.to(torch.int32).contiguous())
    return out


def extend_batch_banded(query, qlen, target, tlen, h0,
                        o_del: int = 6, e_del: int = 1,
                        o_ins: int = 6, e_ins: int = 1,
                        match: int = 1, mismatch: int = 4,
                        zdrop: int = 0, band: int = 100):
    """``extend_batch(band=band)``: kernel K1 on CUDA, plain on CPU."""
    if band <= 0:
        raise ValueError("extend_batch_banded: band must be > 0")
    if not query.is_cuda:
        return extend_batch(query, qlen, target, tlen, h0, o_del=o_del,
                            e_del=e_del, o_ins=o_ins, e_ins=e_ins,
                            match=match, mismatch=mismatch, zdrop=zdrop,
                            band=band)
    return extend_batch_banded_cuda(query, qlen, target, tlen, h0,
                                    o_del, e_del, o_ins, e_ins, match,
                                    mismatch, zdrop, band)


def extend_batch_banded_cuda(query, qlen, target, tlen, h0,
                             o_del: int = 6, e_del: int = 1,
                             o_ins: int = 6, e_ins: int = 1,
                             match: int = 1, mismatch: int = 4,
                             zdrop: int = 0, band: int = 100):
    """Launch kernel K1 (raises on CPU tensors or unsupported shapes)."""
    dev = query.device
    guard = cuda_lib.on_device("extend_batch_banded_cuda", dev, target, qlen,
                               tlen, h0)
    lib = cuda_lib.load(KERNEL)
    if not 0 < band <= lib.sw_extend_max_band():
        raise ValueError(f"extend_batch_banded_cuda: band {band} not in "
                         f"1..{lib.sw_extend_max_band()}")
    if e_del < 0 or e_ins < 0 or o_del < 0 or o_ins < 0:
        raise ValueError("extend_batch_banded_cuda: negative gap penalty")
    M, Lq = query.shape
    if target.shape[0] != M:
        raise ValueError("extend_batch_banded_cuda: batch mismatch")
    Lt = target.shape[1]
    q8 = query.to(torch.int8).contiguous()
    t8 = target.to(torch.int8).contiguous()
    ql, tl, hh = _lane_args("extend_batch_banded_cuda", dev, M, qlen, tlen,
                            h0)
    out = torch.empty((5, M), dtype=torch.int32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    with guard:
        rc = lib.sw_extend_banded(
            vp(q8.data_ptr()), vp(ql.data_ptr()), vp(t8.data_ptr()),
            vp(tl.data_ptr()), vp(hh.data_ptr()), vp(out.data_ptr()),
            ci(M), ci(Lq), ci(Lt), ci(band), ci(o_del), ci(e_del),
            ci(o_ins), ci(e_ins), ci(match), ci(mismatch), ci(zdrop),
            cuda_lib.stream_ptr(dev))
    cuda_lib.check(rc, KERNEL)
    cuda_lib.bump(cuda_lib.LAUNCHES, KERNEL)
    return dict(score=out[0], qle=out[1], tle=out[2], gscore=out[3],
                gtle=out[4])


def extend_batch_adaptive(query, qlen, target, tlen, h0,
                          o_del: int = 6, e_del: int = 1,
                          o_ins: int = 6, e_ins: int = 1,
                          match: int = 1, mismatch: int = 4,
                          zdrop: int = 0, band: int = 100,
                          w1: int = 32, rerun_cap: int = 256):
    """Adaptive-band extension, equal to ``extend_batch(band=band)``.

    Pass 1 runs the narrow band ``w1``.  A lane is band-invariant when
    its pass-1 score and gscore both exceed the best score of any path
    that leaves the narrow band,

        UB = h0 + match*qlen - min(o_del + e_del*(w1+1),
                                   o_ins + e_ins*(w1+1)),

    or when qlen == 0.  Up to ``rerun_cap`` failing lanes are gathered
    into a full-band rerun; more than that rerun the whole batch.  A
    z-drop within the gap bound (0 < zdrop <= that min) could stop a
    full-band lane on a peak outside the narrow band, so such calls go
    straight to the full band."""
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              match=match, mismatch=mismatch, zdrop=zdrop)
    gap_pen = min(o_del + e_del * (w1 + 1), o_ins + e_ins * (w1 + 1))
    if band <= w1 or 0 < zdrop <= gap_pen:
        cuda_lib.bump(ADAPTIVE_BRANCHES, "full_band")
        return extend_batch_banded(query, qlen, target, tlen, h0,
                                   band=band, **kw)
    r1 = extend_batch_banded(query, qlen, target, tlen, h0, band=w1, **kw)
    qlen32 = qlen.to(torch.int32)
    ub = h0.to(torch.int32) + match * qlen32 - gap_pen
    ok = ((r1["score"] > ub) & (r1["gscore"] > ub)) | (qlen32 == 0)
    with profiling.sync("k1.adaptive"):
        bad = torch.nonzero(~ok).flatten()
    n_bad = int(bad.numel())
    B = query.shape[0]
    if n_bad == 0:
        cuda_lib.bump(ADAPTIVE_BRANCHES, "narrow_only")
        return r1
    if n_bad > min(rerun_cap, B):
        cuda_lib.bump(ADAPTIVE_BRANCHES, "full_rerun")
        return extend_batch_banded(query, qlen, target, tlen, h0,
                                   band=band, **kw)
    cuda_lib.bump(ADAPTIVE_BRANCHES, "compact_rerun")
    r2 = extend_batch_banded(query[bad], qlen[bad], target[bad], tlen[bad],
                             h0[bad], band=band, **kw)
    out = {}
    for k, v in r1.items():
        v = v.clone()
        v[bad] = r2[k]
        out[k] = v
    return out


def extend_batch_rect(query, qlen, target, tlen, h0,
                      o_del: int = 6, e_del: int = 1,
                      o_ins: int = 6, e_ins: int = 1,
                      match: int = 1, mismatch: int = 4, zdrop: int = 0):
    """``extend_rect``: kernel K3 on CUDA, plain on CPU."""
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              match=match, mismatch=mismatch, zdrop=zdrop)
    if not query.is_cuda:
        return extend_rect(query, qlen, target, tlen, h0, **kw)
    return launch_rect("sw_extend_rect", query, qlen, target, tlen, h0,
                       **kw)


def launch_rect(entry: str, query, qlen, target, tlen, h0,
                o_del: int = 6, e_del: int = 1, o_ins: int = 6,
                e_ins: int = 1, match: int = 1, mismatch: int = 4,
                zdrop: int = 0, nch: int = 0):
    """Launch one of the rectangle kernels of ``csrc/sw_rect.cu``
    (``entry`` is its C name; ``nch`` only for the interleaved one) on
    CUDA tensors; raises on CPU tensors or shapes it does not take."""
    dev = query.device
    guard = cuda_lib.on_device(entry, dev, target, qlen, tlen, h0)
    lib = cuda_lib.load(RECT_LIB)
    M, Lq = query.shape
    if target.shape[0] != M:
        raise ValueError(f"{entry}: batch mismatch")
    Lt = target.shape[1]
    check_rect_shape(entry, Lq, Lt)
    if lib.sw_rect_max_width() != RECT_MAX_LT:
        raise RuntimeError(f"{entry}: the built kernels take Lt <= "
                           f"{lib.sw_rect_max_width()}, not {RECT_MAX_LT}")
    if min(o_del, e_del, o_ins, e_ins) < 0:
        raise ValueError(f"{entry}: negative gap penalty")
    q8 = query.to(torch.int8).contiguous()
    t8 = target.to(torch.int8).contiguous()
    ql, tl, hh = _lane_args(entry, dev, M, qlen, tlen, h0)
    out = torch.empty((5, M), dtype=torch.int32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ptrs = [vp(x.data_ptr()) for x in (q8, ql, t8, tl, hh, out)]
    tail = [ci(o_del), ci(e_del), ci(o_ins), ci(e_ins), ci(match),
            ci(mismatch), ci(zdrop), cuda_lib.stream_ptr(dev)]
    shape = (ci(M), ci(Lq), ci(Lt)) + ((ci(nch),) if nch else ())
    with guard:
        rc = getattr(lib, entry)(*ptrs, *shape, *tail)
    cuda_lib.check(rc, entry)
    cuda_lib.bump(cuda_lib.LAUNCHES, entry)
    return dict(score=out[0], qle=out[1], tle=out[2], gscore=out[3],
                gtle=out[4])


@functools.lru_cache(maxsize=None)
def _global_plan(device_index: int, Lq: int, Lt: int) -> tuple:
    """(slots a thread, chunks a row, slab bytes a row, warps the card
    holds at once, row-buffer int32 a warp) of ``csrc/global_dp.cu`` at
    these widths (a host query; call it on the card's own device)."""
    out = (ctypes.c_longlong * 5)()
    rc = cuda_lib.load(GLOBAL).global_dp_plan(ctypes.c_int(Lq),
                                              ctypes.c_int(Lt), out)
    cuda_lib.check(rc, "global_dp_plan")
    return tuple(out)


def _slot_rows(M: int) -> int:
    """Rows of the run slots allocated for a call of M rows: the next power
    of two, so that calls of nearby sizes reuse one cached block."""
    return 1 << max(M - 1, 0).bit_length()


def global_traceback_cuda(q, ql, t, tl, o_del: int = 6, e_del: int = 1,
                          o_ins: int = 6, e_ins: int = 1, match: int = 1,
                          mismatch: int = 4, band: int = 208,
                          group: int | None = None):
    """``global_and_traceback`` on CUDA tensors (raises on anything else),
    with no host read: (score int32 [M], nm int32 [M], run_off int64
    [M + 1], runs int32), bit-equal to the plain route.  Row r's CIGAR
    runs, in forward order, are ``runs[run_off[r]:run_off[r + 1]]``, a
    word each: the op (0 M, 1 D, 2 I) in the top 2 bits, the length in
    the low 30; ``runs`` holds ``run_off[M]`` of them and room past.

    Rows go through ``csrc/global_dp.cu`` in launches of at most ``group``
    rows (all in one by default), each writing its rows' runs to a slot of
    Lq + Lt words a row (the most runs a row whose lengths lie inside its
    windows can have) and their counts; one scan of the counts gives
    ``run_off``, and one launch of ``global_dp_gather`` copies the slots'
    runs to ``runs``.  Counts the launches (``cuda_lib.LAUNCHES``: one a
    group, a call of no rows too, and one gather).  While the tracer is
    on, hands the kernel's device totals of ``GLOBAL_COUNTERS`` to
    ``profiling.count_device``: the most DP rows a row ran (the plain
    route's ``global_dp.dp_rows_run``), the exact longest walk (the plain
    route's ``traceback.steps`` rounds it up to a multiple of 8, or to
    T), and the runs handed over.  Codes are uint8, as the aligner makes
    them."""
    dev = q.device
    guard = cuda_lib.on_device("global_traceback_cuda", dev, ql, t, tl)
    if q.dim() != 2 or t.dim() != 2 or t.shape[0] != q.shape[0] \
            or q.dtype != torch.uint8 or t.dtype != torch.uint8:
        raise ValueError("global_traceback_cuda: uint8 codes q [M, Lq] "
                         "and t [M, Lt]")
    M, Lq = q.shape
    Lt = t.shape[1]
    R = Lq + Lt
    group = max(M, 1) if group is None else group
    qb, tb = q.contiguous(), t.contiguous()
    ql32, tl32 = _lane_args("global_traceback_cuda", dev, M, ql, tl)
    score = torch.empty(M, dtype=torch.int32, device=dev)
    nm = torch.empty_like(score)
    run_off = torch.zeros(M + 1, dtype=torch.int64, device=dev)
    slots = torch.empty(_slot_rows(M) * R, dtype=torch.int32, device=dev)
    totals = torch.zeros(len(GLOBAL_COUNTERS), dtype=torch.int64,
                         device=dev) if profiling.enabled() else None
    vp, ci = ctypes.c_void_p, ctypes.c_int

    def ptr(x, g=0):
        return vp(x[g:].data_ptr() if x is not None and x.numel() else None)

    with guard:
        lib = cuda_lib.load(GLOBAL)
        warps, slab, buf = 0, None, None
        if M:
            _, _, row_bytes, resident, buf_ints = _global_plan(
                dev.index, Lq, Lt)
            warps = min(M, group, resident)
            slab = torch.empty(warps * Lq * row_bytes, dtype=torch.uint8,
                               device=dev)
            buf = torch.empty(warps * buf_ints, dtype=torch.int32,
                              device=dev) if buf_ints else None
        for g in range(0, max(M, 1), group):
            n = min(group, M - g)
            rc = lib.global_dp(
                ptr(qb, g), ptr(ql32, g), ptr(tb, g), ptr(tl32, g),
                ptr(score, g), ptr(nm, g), ptr(run_off, g + 1),
                ptr(slots, g * R), ptr(totals), ptr(slab), ptr(buf),
                ci(n), ci(Lq), ci(Lt), ci(band), ci(o_del), ci(e_del),
                ci(o_ins), ci(e_ins), ci(match), ci(mismatch),
                ci(min(n, warps)), cuda_lib.stream_ptr(dev))
            cuda_lib.check(rc, GLOBAL)
            cuda_lib.bump(cuda_lib.LAUNCHES, GLOBAL)
        run_off[1:].cumsum_(0)
        runs = torch.empty(_slot_rows(M) * R, dtype=torch.int32, device=dev)
        rc = lib.global_dp_gather(ptr(slots), ptr(run_off), ptr(runs),
                                  ci(M), ci(R), cuda_lib.stream_ptr(dev))
        cuda_lib.check(rc, GATHER)
        cuda_lib.bump(cuda_lib.LAUNCHES, GATHER)
        if totals is not None:
            profiling.count_device(GLOBAL_COUNTERS, totals)
    return score, nm, run_off, runs
