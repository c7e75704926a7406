"""Seed-extension bench on the GPU: the rectangle kernels K3, K4 and K5,
and the banded kernel K1 at bwa's band, on the JAX package's bench
inputs (counterpart of ``bench.py``'s SW section,
``scripts/sw_banded_bench.py`` and ``scripts/sw_variant_sweep.py``).

    python -m seqlib_tpu_torch.bench_sw

Inputs, made from seed 0 with numpy:
* ``bench``: bench.py's B = 1024 lanes, Lq = 150, Lt = 250, codes 0-3,
  full lengths, h0 = 30;
* ``sweep``: the sweep's codes 0-4, qlen 100-150, tlen 150-250,
  h0 10-150;
* ``edges``: short, empty (qlen 0 or tlen 0) and near-identical lanes;
* the stop-row lanes (``rect_stop_inputs``) at Lt 31, 60, 250, 1023.

First a probe of the DPX instructions (``dpx_probe``: clocks per warp
instruction of the s16x2 and int32 add-max and PRMT, the s16x2 forms'
edge semantics).  Each kernel is then held against its plain version
(``ops.sw.extend_rect``; ``extend_batch(band=100)`` for K1) on every
set, at zdrop 0 and 100 (K5 at 100 only), tolerance 0.  Then, at
zdrop = 100 on the bench set, it is timed: device time per launch over
10 launches queued behind a sleep kernel (``device_ms``; ``ms`` in
chip_smoke.py's kernel line, for every kernel), ms per call with the
Python wrapper from CUDA events over 10 back-to-back calls
(``event_ms``), and the device-time rate of K = 32 dependent launches
(h0 = score % 1000, as bench.py chains them) in Gcells/s over rectangle
cells B*Lq*Lt (band cells for K1, counted as sw_banded_bench.py counts
them).  K1 and K3 are also compared per DP
cell the inputs need, device time on both sides.  Launches of the
checks are not counted; ``run`` returns each kernel's full-batch
launches of the timed part.  Each pipelined kernel's longest lane is
also timed alone (its rows, pipeline steps and ns a step), in launches
that are not counted.  Every line names the card and its power limit.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .ops import cuda_lib
from .ops.sw import extend_batch, extend_rect
from .ops.sw_cuda import extend_batch_banded, extend_batch_rect
from .ops.sw_variants import extend_v3, extend_v4

B, LQ, LT = 1024, 150, 250
ZDROP = 100
CHAIN = 32
BAND = 100
KEYS = ("score", "qle", "tle", "gscore", "gtle")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
# int32 ALU peak: the data sheet's 67 TFLOP/s float32 counts an FMA as
# two operations on 128 lanes per SM; Hopper has 64 INT32 lanes per SM
INT32_OPS_PER_S = 67e12 / 4
# int32 instructions per DP cell, the fewest the card needs (a DPX
# add-max, __viaddmax_s32, counted as one at the int32 rate): F (a
# subtraction and an add-max), the substitution score (one byte-permute
# lookup of the query code's score row by the column's target code),
# H before E (an add-max of the diagonal and the score with F), H (an
# add-max with the E carry), the next E (an add-max), the row max and
# its first column (a max that sets a predicate, a select).  The best
# cell, the z-drop test and gscore take the row maxima, once per row.
OPS_PER_CELL = 8

# the stop-row lanes' target widths and their extra zdrops: 7 (a
# column tie decides whether a lane stops), 10^6 (only a row max <= 0
# stops a lane)
STOP_WIDTHS = (31, 60, 250, 1023)
STOP_ZDROPS = (7, 10**6)


def k3_segment(M: int, Lq: int, Lt: int) -> tuple[int, int]:
    """The segment K3's launcher gives M lanes of Lq x Lt: (threads a
    segment, slots a thread)."""
    v = cuda_lib.load("sw_rect").sw_rect_k3_shape(M, Lq, Lt)
    if v < 0:
        raise ValueError(f"sw_rect_k3_shape: no shape for Lt={Lt}")
    return v // 64, v % 64


def pipe_last(nch: int, Lt: int, tl: int, M: int = 1, Lq: int = 0) -> int:
    """For step counts: the thread of its segment where a lane of tlen
    tl ends each row, in K3 (nch 0, on the segment its launcher gives M
    lanes of Lq x Lt), K4 (nch = 1) or K5 (nch 2, 3) on targets of Lt
    columns, as csrc/sw_rect.cu's launchers shape the pipeline."""
    if nch <= 0:
        P, S = k3_segment(M, Lq, Lt)
        return min(max(min(tl, Lt), 0) // S, P - 1)
    last = cuda_lib.load("sw_rect").sw_rect_pipe_last(Lt, nch, tl)
    if last < 0:
        raise ValueError(f"sw_rect_pipe_last: no pipeline for Lt={Lt}, "
                         f"nch={nch}")
    return last


# the probe's operations (csrc/dpx_probe.cu), in its order
PROBE_OPS = ("viaddmax_s16x2", "viaddmax_s32", "vibmax_s16x2+selects",
             "prmt")


def dpx_probe(dev, iters: int = 4096) -> dict:
    """Clocks a scheduler takes per warp instruction of each PROBE_OPS
    operation: at throughput (8 independent chains a thread, 4 warps on
    each scheduler, one block an SM) and along one dependent chain (one
    warp a scheduler); and the s16x2 forms' edge semantics."""
    lib = cuda_lib.load("dpx_probe")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = cuda_lib.stream_ptr(dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    out = {}
    for op, name in enumerate(PROBE_OPS):
        res = {}
        for label, ch, warps in (("throughput", 8, 4), ("latency", 1, 1)):
            threads = 4 * 32 * warps
            clk = torch.zeros(sms * threads // 32, dtype=torch.int64,
                              device=dev)
            for _ in range(2):              # the first launch warms up
                cuda_lib.check(lib.dpx_probe(
                    vp(clk.data_ptr()), vp(sink.data_ptr()), ci(op),
                    ci(ch), ci(sms), ci(threads), ci(iters), stream),
                    "dpx_probe")
            torch.cuda.synchronize()
            res[label] = float(clk.double().mean()) / (iters * ch * warps)
        out[name] = res
    sem = torch.zeros(8, dtype=torch.int32, device=dev)
    cuda_lib.check(lib.dpx_semantics(vp(sem.data_ptr()), stream),
                   "dpx_semantics")
    v = [int(x) & 0xffffffff for x in sem.cpu()]
    out["semantics"] = dict(
        add_wraps=(v[0] >> 16) == 0xfffb and v[6] == 0x7fff7fff,
        add_saturates=(v[0] >> 16) == 0x7fff and v[6] == 0x80008000,
        # __vibmax_s16x2(a, b, &pred_hi, &pred_lo): max per half, and
        # a >= b per half as declared (a = (5, 1), b = (3, 2) sets pred_hi
        # only; equal halves and a = (1, 1), b = (0, 0) set both).  The
        # toolkit's inline asm reads a after writing the max to an output
        # that may share its register (no early clobber), so the
        # predicates can differ from build to build; K3 does not use them
        vibmax_max=v[1] == 0x00050002,
        vibmax_preds_as_declared=v[2] == 2 and v[3] == 3 and v[7] == 3,
        vmaxs2_ok=v[4] == 0x7fff0005,
        prmt_sign=v[5] == 0x0001fffc,
        raw=[f"{x:08x}" for x in v])
    return out


class RectKernel(NamedTuple):
    counter: str        # its launch counter (and C entry point)
    replaces: str       # the TPU kernel it replaces
    zdrops: tuple       # the zdrops it is checked at
    fns: dict           # its wrappers, by label
    nch: dict           # per label: pipe_last's nch (K3: 0)


RECT_KERNELS = {
    "K3": RectKernel("sw_extend_rect", "seqlib_tpu/ops/sw_pallas.py:55",
                     (0, ZDROP), {"": extend_batch_rect}, {"": 0}),
    "K4": RectKernel("sw_extend_rect_blocked",
                     "scripts/sw_variant_sweep.py:21", (0, ZDROP),
                     {"": extend_v3}, {"": 1}),
    "K5": RectKernel("sw_extend_rect_interleaved",
                     "scripts/sw_variant_sweep.py:188", (ZDROP,),
                     {"nch=2": functools.partial(extend_v4, nch=2),
                      "nch=3": functools.partial(extend_v4, nch=3)},
                     {"nch=2": 2, "nch=3": 3}),
}
# device ms per launch on these inputs of the earlier layouts (K3 a warp
# per lane in row order, K4 a blocked warp scan, K5 a thread per nch
# lanes with its rows in device memory) and the chip run each was read
# in (PERF.md), H100 80GB HBM3, 700 W
EARLIER_MS = {("K3", ""): ("P6-D", 0.0312), ("K4", ""): ("P4-C", 0.0569),
              ("K5", "nch=2"): ("P4-C", 4.3148),
              ("K5", "nch=3"): ("P4-B", 6.70)}
SOURCE = "seqlib_tpu_torch/csrc/sw_rect.cu"


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of fn() on the card (CUDA events, after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device time per call (ms) of fn(): ``reps`` calls queued
    behind a sleep kernel, so the host's work on them (the Python
    wrapper) overlaps the sleep and the card runs them back to back,
    timed with CUDA events around the ``reps`` calls, after a warm-up
    call.  The sleep grows until it outlasts the host's queueing; raises
    if it never does (fn waits on the card)."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(6):
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        b.record()
        torch.cuda.synchronize()
        if host_ms < 0.5 * s.elapsed_time(a):
            return a.elapsed_time(b) / reps
        cycles *= 4
    raise RuntimeError("device_ms: the calls take longer to queue than the "
                       "sleep lasts; does fn wait on the card?")


def roof_ms(nbytes: int, ops: int) -> tuple[float, str]:
    """(max(bytes / HBM rate, int32 ops / int32 rate) in ms, which of
    the two bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def max_abs_diff(a: dict, b: dict, keys=KEYS) -> int:
    return max(int((a[k].to(torch.int64) - b[k].to(torch.int64))
                   .abs().max()) if a[k].numel() else 0 for k in keys)


def _tensors(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def bench_inputs(dev, seed: int = 0):
    """bench.py's SW inputs: codes 0-3, full lengths, h0 = 30."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, LQ)).astype(np.int8)
    t = rng.integers(0, 4, (B, LT)).astype(np.int8)
    return _tensors(dev, q, np.full(B, LQ, np.int32), t,
                    np.full(B, LT, np.int32), np.full(B, 30, np.int32))


def sweep_inputs(dev, seed: int = 0):
    """scripts/sw_variant_sweep.py's inputs: codes 0-4, qlen 100-150,
    tlen 150-250, h0 10-150."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (B, LQ)).astype(np.int8)
    t = rng.integers(0, 5, (B, LT)).astype(np.int8)
    ql = rng.integers(100, LQ + 1, B).astype(np.int32)
    tl = rng.integers(150, LT + 1, B).astype(np.int32)
    h0 = rng.integers(10, 151, B).astype(np.int32)
    return _tensors(dev, q, ql, t, tl, h0)


def edge_inputs(dev, seed: int = 1):
    """Short, empty and near-identical lanes: a third of the lanes align
    their query to the target with a few substitutions (long live
    rows), a tenth have qlen = 0, a twentieth tlen = 0, a fifth are
    short."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (B, LQ)).astype(np.int8)
    t = rng.integers(0, 5, (B, LT)).astype(np.int8)
    ql = rng.integers(1, LQ + 1, B).astype(np.int32)
    tl = rng.integers(1, LT + 1, B).astype(np.int32)
    h0 = rng.integers(0, 80, B).astype(np.int32)
    kind = rng.random(B)
    for m in np.flatnonzero(kind < 0.33):
        n = int(ql[m])
        t[m, :n] = q[m, :n]
        tl[m] = max(int(tl[m]), n)
        for p in rng.integers(0, n, int(rng.integers(0, 4))):
            t[m, p] = (t[m, p] + 1) % 4
    short = (kind >= 0.33) & (kind < 0.53)
    ql[short] = rng.integers(1, 21, int(short.sum()))
    ql[kind >= 0.9] = 0
    tl[(kind >= 0.85) & (kind < 0.9)] = 0
    return _tensors(dev, q, ql, t, tl, h0)


# the rows where rect_stop_inputs' lanes stop: 0, 1, P - 2, P - 1, P and
# 2P for each pipeline depth P of kernels K4 and K5 (10, 16, 32)
STOP_ROWS = sorted({0, 1} | {r for P in (10, 16, 32)
                             for r in (P - 2, P - 1, P, 2 * P)})


def _stop_lane(q, t, R: int, Lt: int) -> int:
    """Make lane (q, t) stop on row R under any zdrop > 0; returns its
    h0.  The target's first r + 1 codes copy the query's, and the query
    is N (code 4) after row r, so row r holds the peak h0 + r + 1 on the
    diagonal and row r + d's max is max(peak - 4d, peak - 6 - d) at the
    default penalties (a mismatch run or an insertion from the peak): it
    falls to <= 0 on a chosen row, while the gap-corrected drop stays <=
    6.  R = 0 copies nothing and takes h0 = 2 (row 0's max is h0 - 4)."""
    if R == 0:
        q[:] = 4
        return 2
    if R <= 2:                      # peak <= 4 stops at d = 1, <= 8 at 2
        r, h0 = (0, 3) if R == 1 else (0, 5)
    else:                           # d = peak - 6 >= 3
        r = min((R - 3) // 2, Lt - 1)
        h0 = R - 2 * r + 5
    t[:r + 1] = q[:r + 1]
    q[r + 1:] = 4
    return h0


def rect_stop_inputs(dev, seed: int = 0, M: int = 64, Lq: int = 150,
                     Lt: int = 250):
    """Lanes whose z-drop stop lands on chosen rows, for the pipelined
    kernels K4 and K5, which compute P rows at once and drop the rows
    past a stop (the default penalties; every stop below holds for any
    zdrop > 0 and comes from the row max falling to <= 0, the
    gap-corrected drop never exceeding 6):

    * a stop on each row of ``STOP_ROWS`` below Lq and on the last row
      Lq - 1, three times: qlen = Lq; qlen = stop row + 1 (gscore on
      the stop row); qlen = stop row + 2 (the last row is one past the
      stop, so its gscore is dead);
    * an exact tie between two columns of one row: row r + 2 after a
      peak on row r holds peak - 8 at columns r + 1 and r + 3, for r + 1,
      r + 3 on both sides of a strip edge of 4, 8, 16 and 32 columns
      (columns 7 | 9, 14 | 16, 30 | 32); with qlen = r + 3 it is the
      gscore row, and at zdrop 7 the smaller column keeps the lane
      alive (drop 6) where the larger one would stop it (drop 8);
    * an exact tie between two rows' maxima (the best cell): a peak on
      row r, one mismatch, four matches, the peak again on row r + 5;
    * two lanes of identical query and target (never stopped by the gap
      test; the row max stays positive), h0 in {0, 3, 5} (h0 < o_del,
      so row 0 of the rectangle is dead past column 0), qlen = 0, qlen >
      Lq, tlen = 0 and tlen > Lt;
    * random lanes (codes 0-4) up to M lanes.

    Lane order is fixed; rows up to 2 * 32 need Lq >= 66 and Lt >= 32.
    """
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (M, Lq)).astype(np.int8)
    t = rng.integers(0, 4, (M, Lt)).astype(np.int8)
    ql = np.full(M, Lq, np.int32)
    tl = np.full(M, Lt, np.int32)
    h0 = np.full(M, 30, np.int32)
    m = 0
    for R in [R for R in STOP_ROWS if R < Lq - 1] + [Lq - 1]:
        for last in (Lq, R + 1, R + 2):
            h0[m] = _stop_lane(q[m], t[m], R, Lt)
            ql[m] = last
            m += 1
    for r in (6, 13, 29):                   # column ties on row r + 2
        if r + 3 > min(Lt, Lq - 1):
            continue
        for last in (False, True):
            t[m, :r + 1] = q[m, :r + 1]
            q[m, r + 1:] = 4
            h0[m] = 20
            if last:
                ql[m] = r + 3
            m += 1
    for r in (9, 31):                       # row tie: rows r and r + 5
        if r + 6 > min(Lt, Lq - 1):
            continue
        t[m, :r + 1] = q[m, :r + 1]
        t[m, r + 1] = (q[m, r + 1] + 1) % 4
        t[m, r + 2:r + 6] = q[m, r + 2:r + 6]
        q[m, r + 6:] = 4
        h0[m] = 10
        m += 1
    n = min(Lq, Lt)
    for k in range(2):                      # identical query and target
        t[m, :n] = q[m, :n]
        h0[m] = 1 + 40 * k
        m += 1
    for v in (0, 3, 5):                     # h0 < o_del
        t[m, :n // 2] = q[m, :n // 2]
        h0[m] = v
        m += 1
    ql[m], tl[m + 1], tl[m + 3] = 0, 0, Lt + 9
    ql[m + 2] = Lq + 5
    m += 4
    if m > M:
        raise ValueError(f"rect_stop_inputs: needs M >= {m}")
    q[m:] = rng.integers(0, 5, (M - m, Lq))
    t[m:] = rng.integers(0, 5, (M - m, Lt))
    ql[m:] = rng.integers(1, Lq + 1, M - m)
    tl[m:] = rng.integers(1, Lt + 1, M - m)
    h0[m:] = rng.integers(0, 60, M - m)
    return _tensors(dev, q, ql, t, tl, h0)


def set_k1_edges(ql, tl, h0, w: int, Lt: int, rng) -> None:
    """Make lanes (numpy arrays, changed in place) edge cases of kernel
    K1's band of width w, by lane index mod 8: 0 has qlen = 0, 1
    tlen < w, 2 tlen = Lt, 3 tlen > Lt (the DP reads min(tlen, Lt)), 4
    h0 in 0..5, so row 0 has NEG cells (h0 - o_del - e_del*j < 0)."""
    e = np.arange(ql.shape[0]) % 8
    ql[e == 0] = 0
    tl[e == 1] = rng.integers(0, w, int((e == 1).sum()))
    tl[e == 2] = Lt
    tl[e == 3] = Lt + 7
    h0[e == 4] = rng.integers(0, 6, int((e == 4).sum()))


def k1_edge_inputs(dev, M: int, Lq: int, Lt: int, w: int, seed: int = 0):
    """Random lanes (codes 0-4), near-identical ones in every other lane
    (target = query with two substitutions), and K1's edge lanes
    (``set_k1_edges``)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (M, Lq)).astype(np.int8)
    t = rng.integers(0, 5, (M, Lt)).astype(np.int8)
    ql = rng.integers(1, Lq + 1, M).astype(np.int32)
    tl = rng.integers(0, Lt + 1, M).astype(np.int32)
    h0 = rng.integers(6, 60, M).astype(np.int32)
    for m in range(0, M, 2):
        n = min(int(ql[m]), Lt)
        t[m, :n] = q[m, :n]
        tl[m] = max(int(tl[m]), n)
        for p in rng.integers(0, max(n, 1), 2):
            t[m, p] = (t[m, p] + 1) % 4
    set_k1_edges(ql, tl, h0, w, Lt, rng)
    return _tensors(dev, q, ql, t, tl, h0)


def k1_long_inputs(dev, M: int, Lq: int, w: int, seed: int = 0):
    """Long near-identical lanes for kernel K1 (Lt = Lq + w + 1), so that
    every row runs: each target is its query with 0.3% substitutions and
    a 1-4 bp insertion or deletion about every 1.5 kb (alternating, so
    the path stays inside a band of w >= 8); lane 1 has a 300-base block
    of mismatches at mid-read (a z-drop stops it there), every 8th lane
    a qlen a few hundred rows short, and h0 is 19-60."""
    rng = np.random.default_rng(seed)
    Lt = Lq + w + 1
    q = rng.integers(0, 4, (M, Lq)).astype(np.int8)
    t = np.full((M, Lt), 4, np.int8)
    ql = np.full(M, Lq, np.int32)
    ql[::8] -= rng.integers(1, 400, ql[::8].size).astype(np.int32)
    tl = np.zeros(M, np.int32)
    h0 = rng.integers(19, 61, M).astype(np.int32)
    for m in range(M):
        parts, cur, k = [], 0, 0
        for cut in range(1500, Lq - 100, 1500):
            parts.append(q[m, cur:cut])
            d = int(rng.integers(1, 5))
            if k % 2:                                   # deletion
                cur = cut + d
            else:                                       # insertion
                parts.append(rng.integers(0, 4, d).astype(np.int8))
                cur = cut
            k += 1
        parts.append(q[m, cur:])
        row = np.concatenate(parts)[:Lt]
        hit = np.flatnonzero(rng.random(row.size) < 0.003)
        row[hit] = (row[hit] + rng.integers(1, 4, hit.size)) % 4
        if m == 1:
            mid = row.size // 2
            row[mid:mid + 300] = (row[mid:mid + 300] + 1) % 4
        t[m, :row.size] = row
        tl[m] = row.size
    return _tensors(dev, q, ql, t, tl, h0)


def rect_cells(args, rows: torch.Tensor) -> int:
    """DP cells these lanes need: the rows each lane computed (from the
    plain version) times its tlen + 1 columns."""
    _, _, t, tl, _ = args
    cols = torch.clamp(tl.to(torch.int64), 0, t.shape[1]) + 1
    return int((rows.to(torch.int64) * cols).sum())


def band_cells(Lq: int, Lt: int, w: int) -> int:
    """Band cells of a full-length lane under |j - R| <= w
    (scripts/sw_banded_bench.py's count)."""
    return sum(max(0, min(Lt, R + w) - max(0, R - w) + 1)
               for R in range(1, Lq + 1))


def band_cells_needed(args, w: int, rows: torch.Tensor) -> int:
    """Band cells the DP computes for these lanes (rows = DP rows each
    lane ran, from the plain version)."""
    q, _, t, tl, _ = args
    Lq, Lt = q.shape[1], t.shape[1]
    R = torch.arange(1, Lq + 1, device=q.device)[None, :]
    tle = torch.clamp(tl.to(torch.int64), max=Lt)[:, None]
    live = torch.clamp(torch.minimum(R + w, tle) - torch.clamp(R - w, min=0)
                       + 1, min=0)
    return int((live * (R <= rows.to(torch.int64)[:, None])).sum())


def rect_bound_ms(args, rows) -> tuple[float, str]:
    q, _, t, _, _ = args
    M = q.shape[0]
    nbytes = q.numel() + t.numel() + 3 * 4 * M + 5 * 4 * M
    return roof_ms(nbytes, OPS_PER_CELL * rect_cells(args, rows))


def chained_ms(fn, args) -> float:
    """Device ms for CHAIN dependent launches (h0 = score % 1000 each
    step)."""
    q, ql, t, tl, h0 = args

    def chain():
        h = h0
        for _ in range(CHAIN):
            h = fn(q, ql, t, tl, h)["score"] % 1000
        return h

    return device_ms(chain, 1)


def longest_lane(fn, args, rows, nch) -> dict:
    """The lane with the most rows (from the plain version) alone on the
    card, and an empty lane (qlen 0) alone, the launch's floor: device
    ms of each, the lane's rows and the steps its dependent chain takes
    (rows + the segment's last live thread + 1: its pipeline fill and the
    stop's broadcast), and ns a step net of the floor.  K3 (nch <= 0),
    whose segment shape depends on the batch, runs it in a batch of the
    call's lanes with every other lane empty, and its floor is a batch of
    empty lanes; K4 and K5 run one-lane launches."""
    m = int(torch.argmax(rows))
    M, Lq = args[0].shape
    Lt = args[2].shape[1]
    if nch <= 0:
        one = [a.clone() for a in args]
        keep = torch.zeros(M, dtype=torch.bool, device=one[1].device)
        keep[m] = True
        one[1] = torch.where(keep, one[1], torch.zeros_like(one[1]))
    else:
        one = [a[m:m + 1] for a in args]
    empty = [a.clone() for a in one]
    empty[1].zero_()
    ms = device_ms(lambda: fn(*one, zdrop=ZDROP), 10)
    ms0 = device_ms(lambda: fn(*empty, zdrop=ZDROP), 10)
    n = int(rows[m])
    steps = n + pipe_last(nch, Lt, int(args[3][m]), M=M, Lq=Lq) + 1
    return dict(rows=n, steps=steps, ms=ms, empty_ms=ms0,
                step_ns=1e6 * (ms - ms0) / max(steps, 1))


def run(dev, log=print) -> dict:
    """Check K3, K4, K5 (and K1 at band 100) against their plain
    versions on the card, then time them; returns, for K3-K5, the
    fields of chip_smoke.py's kernel line (full-batch launches of the
    timed part, max_abs_err, ms, event_ms, plain_ms, bound_ms, bound_by,
    ...).
    Raises if a kernel differs from its plain version."""
    card = smi_name_power()
    probe = dpx_probe(dev)
    sem = probe.pop("semantics")
    log("dpx probe, clocks a scheduler per warp instruction (throughput: "
        "8 chains, 4 warps a scheduler; latency: one chain): " + "; ".join(
            f"{k} {v['throughput']:.2f} / {v['latency']:.2f}"
            for k, v in probe.items()) + f"; s16x2 semantics {sem} [{card}]")
    sets = {"bench": bench_inputs(dev), "sweep": sweep_inputs(dev),
            "edges": edge_inputs(dev)}
    stops = {f"stop{lt}": rect_stop_inputs(dev, Lt=lt)
             for lt in STOP_WIDTHS}
    # ---- exactness first (these launches are not counted) ------------
    errs = {}
    for name, k in RECT_KERNELS.items():
        err = 0
        for label, fn in k.fns.items():
            for sname, args in {**sets, **stops}.items():
                zds = k.zdrops + (STOP_ZDROPS if sname in stops else ())
                for zd in zds:
                    e = max_abs_diff(fn(*args, zdrop=zd),
                                     extend_rect(*args, zdrop=zd))
                    if e:
                        raise AssertionError(
                            f"{name} {label} differs from extend_rect on "
                            f"{sname} zdrop={zd} (max |diff| {e})")
                    err = max(err, e)
        errs[name] = err
        log(f"{name} {SOURCE}: bit-equal to extend_rect on "
            f"{'/'.join(sets)} x zdrop {k.zdrops} and the stop-row lanes "
            f"at Lt {'/'.join(map(str, STOP_WIDTHS))} x zdrop "
            f"{k.zdrops + STOP_ZDROPS} (tolerance 0)")
    for sname, args in sets.items():
        e = max_abs_diff(extend_batch_banded(*args, band=BAND, zdrop=ZDROP),
                         extend_batch(*args, band=BAND, zdrop=ZDROP))
        if e:
            raise AssertionError(f"K1 differs on {sname} (max |diff| {e})")
    log(f"K1 band={BAND}: bit-equal to extend_batch(band={BAND}) on "
        f"{'/'.join(sets)} (tolerance 0)")

    # ---- timing on bench.py's inputs ---------------------------------
    args = sets["bench"]
    plain = extend_rect(*args, zdrop=ZDROP, return_rows=True)
    cells_rect = B * LQ * LT
    bound = rect_bound_ms(args, plain["rows"])
    plain_ms = cuda_ms(lambda: extend_rect(*args, zdrop=ZDROP), 1)
    log(f"bench inputs B={B} Lq={LQ} Lt={LT} zdrop={ZDROP}: "
        f"{rect_cells(args, plain['rows']) / 1e6:.2f} M cells needed of "
        f"{B * LQ * (LT + 1) / 1e6:.2f} M; plain extend_rect "
        f"{plain_ms:.1f} ms; bound {bound[0]:.4f} ms ({bound[1]}) [{card}]")
    # launches of full bench batches; the longest lane's one-lane
    # launches are left out
    launches = dict.fromkeys(cuda_lib.LAUNCHES, 0)
    P, S = k3_segment(B, LQ, LT)
    log(f"K3 segments for {B} lanes of {LQ} x {LT}: {P} threads x {S} "
        f"slots [{card}]")
    out = {}
    for name, k in RECT_KERNELS.items():
        ms_each = []
        for label, fn in k.fns.items():
            before = cuda_lib.LAUNCHES[k.counter]
            ev = cuda_ms(lambda: fn(*args, zdrop=ZDROP), 10)
            dv = device_ms(lambda: fn(*args, zdrop=ZDROP), 10)
            ch = chained_ms(functools.partial(fn, zdrop=ZDROP), args)
            launches[k.counter] += cuda_lib.LAUNCHES[k.counter] - before
            one = longest_lane(fn, args, plain["rows"], k.nch[label])
            ms_each.append((dv, ev))
            run_id, was = EARLIER_MS[name, label]
            log(f"{name} {label}: device time per launch {dv:.4f} ms "
                f"(10 queued launches; {run_id} {was}); "
                f"{ev:.3f} ms/call with the wrapper (CUDA events over 10 "
                f"calls); chained x{CHAIN}: {ch:.2f} ms = "
                f"{cells_rect * CHAIN / (ch * 1e-3) / 1e9:.1f} Gcells/s "
                f"(rectangle cells); its longest lane alone: "
                f"{one['rows']} rows, {one['steps']} steps, "
                f"{one['ms']:.4f} ms, an empty lane alone "
                f"{one['empty_ms']:.4f} ms: {one['step_ns']:.1f} ns a "
                f"step net of it ({1e6 * one['ms'] / one['steps']:.1f} "
                f"gross) [{card}]")
        # the first variant stands for the kernel (K5: nch = 2)
        out[name] = dict(
            name=k.counter, route="cuda", source=SOURCE,
            replaces=k.replaces, max_abs_err=errs[name], ms=ms_each[0][0],
            event_ms=ms_each[0][1], plain_ms=plain_ms, bound_ms=bound[0],
            bound_by=bound[1], library_ms=None)
    kb = dict(band=BAND, zdrop=ZDROP)
    ev1 = cuda_ms(lambda: extend_batch_banded(*args, **kb), 10)
    dv1 = device_ms(lambda: extend_batch_banded(*args, **kb), 10)
    ch1 = chained_ms(functools.partial(extend_batch_banded, **kb), args)
    cb = B * band_cells(LQ, LT, BAND)
    log(f"K1 band={BAND}: device time per launch {dv1:.4f} ms (10 queued "
        f"launches); {ev1:.3f} ms/call with the wrapper (CUDA events); "
        f"chained x{CHAIN}: {ch1:.2f} ms = "
        f"{cb * CHAIN / (ch1 * 1e-3) / 1e9:.1f} Gcells/s (band cells, "
        f"{cells_rect / cb:.2f}x fewer than the rectangle), "
        f"{cells_rect * CHAIN / (ch1 * 1e-3) / 1e9:.1f} rectangle-equivalent "
        f"[{card}]")
    # device time per DP cell these inputs need (z-drop stops lanes early)
    n3 = rect_cells(args, plain["rows"])
    n1 = band_cells_needed(
        args, BAND, extend_batch(*args, return_rows=True, **kb)["rows"])
    ns3 = 1e6 * out["K3"]["ms"] / n3
    ns1 = 1e6 * dv1 / n1
    log(f"per needed cell, device time on both sides: K1 {ns1 * 1e3:.3f} ps "
        f"({n1 / 1e6:.2f} M band cells), K3 {ns3 * 1e3:.3f} ps "
        f"({n3 / 1e6:.2f} M rectangle cells): K3/K1 = x{ns1 / ns3:.2f} "
        f"[{card}]")
    torch.cuda.synchronize()
    for name, v in out.items():
        v["launches"] = launches[v["name"]]
        if v["launches"] <= 0:
            raise AssertionError(f"{name} was not launched on the bench path")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_sw: torch.cuda.is_available() is False; this bench "
              "runs the kernels on a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{smi_name_power()}", flush=True)
    for lib, rep in cuda_lib.build_all().items():
        for kern, regs, frame, st, ld in cuda_lib.ptxas_report(rep):
            print(f"ptxas[{lib}]: {kern}: {regs} registers, stack frame "
                  f"{frame} B, spill stores {st} B, spill loads {ld} B",
                  flush=True)
    run(dev, log=lambda *a: print(*a, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
