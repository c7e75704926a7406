"""GPU smoke run of the PyTorch/CUDA port (seqlib_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
last line is printed):

1. device: name, capability, ``nvidia-smi`` name and power limit;
2. build: every CUDA kernel library from ``seqlib_tpu_torch/csrc``, one
   nvcc per source, all at once (ptxas's registers and spills are
   printed for every kernel and template instance);
3. a seeded 4.6 Mbp reference (one contig with planted repeats) and
   32,768 simulated 150 bp reads; the port's FM-index and aligner;
4. one 4096-read batch through ``align_batch_bam`` on the card, which
   also records every kernel call's inputs;
5. kernels: K1 (banded extension) and K2 (SMEM machine) held against
   their plain PyTorch versions on the card, bit for bit (tolerance 0),
   on the recorded main-path inputs and on synthetic cases (random,
   near-identical and empty lanes, w in {32, 100}, zdrop in {0, 100},
   all three branches of the adaptive-band wrapper), on an edge phase
   at the main path's widths (K1: M = 3072 and 3069 lanes, w in {1,
   20, 57, 128}, lanes with qlen = 0, tlen < w, tlen = Lt, tlen > Lt
   and NEG cells in row 0; K2: B = 4096 reads with N codes, empty and
   inactive lanes, stack depth C in {1, 16}, reads of 960 bp at
   L = 1024, and a truncating step cap), and timed: device time per
   launch of calls queued behind a sleep kernel (``ms``, printed per
   recorded call beside the earlier kernels' time for the same call
   shape, run P2-E in PERF.md) and ms per
   call with the Python wrapper, back to back (``event_ms``), both with
   CUDA events;
6. main path: 8 x 4096 reads through ``align_stream_bam`` on the card
   with the launch counters reset just before and read just after;
   the first batch's SAM must equal the port's CPU run byte for byte,
   and at least 98% of reads must place their primary record at the
   simulated position;
7. numbers: reads/s, stage times and the profiler's top device ops;
8. overflow path and object API: the 1000-read repeat corpus
   (``sim.make_repeat_reads``) as one chunk through ``align_batch`` on
   the card, launch counters reset just before and read just after: it
   overflows the extension DP rows, so the batch reruns on the classic
   path (``stats["fused_overflow_fallback"] == 1``, K1 and K2 launched);
   what every K1 and K2 call of that run returned is held against the
   plain version on the same inputs, tolerance 0; its SAM must equal
   the non-``#`` lines of ``tests/golden/sam_repeat_1k.txt`` (the JAX
   package's output) byte for byte, and ``align_batch_bam(sam=True)``
   on the same batch must equal the records' ``to_sam`` lines;
9. rectangle kernels K3, K4, K5 (``bench_sw.run``): each held against
   its plain version on the card, tolerance 0, on bench.py's inputs, the
   variant sweep's and a set of short and empty lanes, at zdrop 0 and
   100 (K5: 100 only); then timed on the extension bench path (device
   time per launch and per-call wrapper time, as for K1 and K2), whose
   launches they report;
10. one JSON line of all five kernels' numbers.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from seqlib_tpu_torch import bench_sw
from seqlib_tpu_torch.align import BWAAligner
from seqlib_tpu_torch.bench_sw import (band_cells_needed, cuda_ms,
                                       device_ms, k1_edge_inputs,
                                       max_abs_diff, roof_ms,
                                       smi_name_power)
from seqlib_tpu_torch.index import FMIndex
from seqlib_tpu_torch.ops import cuda_lib, fm_cuda, sw_cuda
from seqlib_tpu_torch.ops.fm import _smem_machine
from seqlib_tpu_torch.ops.sw import extend_batch
from seqlib_tpu_torch.sim import (edge_read_batch, make_genome,
                                  make_repeat_genome, make_repeat_reads,
                                  placement_rate, simulate_reads)

GENOME_BP = 4_600_000
BATCH = 4096
N_BATCHES = 8
READ_BP = 150
GOLDEN_REPEAT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "golden", "sam_repeat_1k.txt")
K1_OPS_PER_CELL = 14               # int32 ops per band cell
# K2's int32 operations, counted from csrc/smem_machine.cu: per BWT word
# a rank popcounts, 7 to build the word's mask (sub, max, min, test,
# shift, sub, shift) and 8 per code (xor, not, shift, 3 ands, popc,
# add); per bi-extension 32 (two ranks' sentinel adjust, row address
# and in-block offset: 2 x 6; k + s, four S/K pairs: 12; the sentinel
# test and the L chain: 7).  The machine's per-step bookkeeping (mode
# tests, stack pushes, seed stores) is not counted, so the bound is low
# by that much.
K2_OPS_PER_WORD = 7 + 4 * 8
K2_OPS_PER_EXT = 32
# Device ms per call of the earlier, one-thread-per-lane K1 and K2 on the
# same call shapes (PERF.md, chip run P2-E, H100 80GB HBM3 at 700 W),
# printed beside this run's times: K1 by (M, w), K2 by (B, max_seeds);
# a shape the batch calls twice lists its calls in the batch's order
P2E_K1_MS = {(3072, 32): [0.3635, 0.4437], (65, 100): [0.6171],
             (80, 100): [0.7021], (256, 32): [0.3643, 0.1231]}
P2E_K2_MS = {(4096, 16): [1.6698], (4096, 4): [0.5407]}


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# K1: banded extension
# ---------------------------------------------------------------------------

def k1_inputs(gen: np.random.Generator, M: int, Lq: int, Lt: int,
              near: float, empty: float, dev):
    """Main-path-shaped extension lanes: random lanes, near-identical
    lanes (target = query with ~1% edits) and qlen = 0 lanes."""
    q = gen.integers(0, 4, (M, Lq)).astype(np.int8)
    t = gen.integers(0, 4, (M, Lt)).astype(np.int8)
    ql = gen.integers(1, Lq + 1, M).astype(np.int32)
    tl = np.minimum(ql + gen.integers(0, Lt - Lq + 1, M), Lt).astype(np.int32)
    h0 = gen.integers(19, 60, M).astype(np.int32)
    kind = gen.random(M)
    for m in np.flatnonzero(kind < near):
        n = int(ql[m])
        t[m, :n] = q[m, :n]
        nerr = int(gen.integers(0, 4))
        for p in gen.integers(0, n, nerr):
            t[m, p] = (t[m, p] + 1) % 4
        if gen.random() < 0.3:          # a short indel
            cut = int(gen.integers(1, max(n, 2)))
            k = int(gen.integers(1, 5))
            t[m, cut:Lt] = np.roll(t[m, cut:Lt], k if gen.random() < 0.5
                                   else -k)
    ql[kind > 1.0 - empty] = 0
    q[np.arange(Lq)[None, :] >= ql[:, None]] = 4
    t[np.arange(Lt)[None, :] >= tl[:, None]] = 4
    return [torch.from_numpy(x).to(dev) for x in (q, ql, t, tl, h0)]


def k1_bound_ms(args, w: int, rows) -> tuple[float, str]:
    """Roofline bound of one K1 call (``roof_ms``) over the band cells
    these lanes need."""
    q, _, t, _, _ = args
    M = q.shape[0]
    nbytes = q.numel() + t.numel() + 3 * 4 * M + 5 * 4 * M
    ops = K1_OPS_PER_CELL * band_cells_needed(args, w, rows)
    return roof_ms(nbytes, ops)


def check_k1(args, w: int, zdrop: int, what: str) -> None:
    kw = dict(band=w, zdrop=zdrop)
    got = sw_cuda.extend_batch_banded_cuda(*args, **kw)
    want = extend_batch(*args, **kw)
    err = max_abs_diff(got, want)
    if err:
        raise AssertionError(f"K1 {what} w={w} zdrop={zdrop}: kernel differs "
                             f"from plain (max |diff| {err})")


def check_adaptive(gen, dev):
    """The adaptive wrapper on inputs that force each branch."""
    M, Lq, w = 3072, 160, 100
    Lt = Lq + w + 1
    cases = {"narrow_only": (1.0, 0.0), "compact_rerun": (0.95, 0.0),
             "full_rerun": (0.0, 0.0)}
    for branch, (near, empty) in cases.items():
        for _ in range(20):
            args = k1_inputs(gen, M, Lq, Lt, near, empty, dev)
            if branch == "narrow_only":
                # exact lanes: far above the out-of-band bound
                args[2][:, :Lq] = args[0]
                args[3] = args[1].clone()
            before = dict(sw_cuda.ADAPTIVE_BRANCHES)
            got = sw_cuda.extend_batch_adaptive(*args, band=w, zdrop=100)
            moved = [k for k in before
                     if sw_cuda.ADAPTIVE_BRANCHES[k] != before[k]]
            if moved == [branch]:
                break
        else:
            raise AssertionError(f"could not force adaptive branch {branch}")
        want = extend_batch(*args, band=w, zdrop=100)
        err = max_abs_diff(got, want)
        if err:
            raise AssertionError(f"adaptive {branch}: differs from "
                                 f"extend_batch(band={w}) (max |diff| {err})")
        log(f"K1 adaptive branch {branch}: equal to extend_batch(band={w}) "
            "(tolerance 0)")


def _kernel_name(mangled: str) -> str:
    """kernel or kernel<S> from an Itanium-mangled entry name: the last
    <length><identifier> of its (nested) name, then an int template
    argument if there is one."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while (m := re.match(r"\d+", mangled[pos:])):
        pos += m.end()
        name = mangled[pos:pos + int(m.group())]
        pos += len(name)
    tm = re.match(r"ILi(\d+)E", mangled[pos:])
    return name + (f"<{tm.group(1)}>" if tm else "")


def ptxas_report(text: str) -> list[tuple[str, int, int, int, int]]:
    """(kernel, registers, stack-frame bytes, spill-store bytes,
    spill-load bytes) per entry function of nvcc's ``-Xptxas -v``
    output; a template instance is named kernel<S>."""
    out, name, spill = [], None, (0, 0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            spill = (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            spill = tuple(int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spill))
            name = None
    return out


def sass_counts() -> dict[str, int]:
    """Static SASS instruction count of every kernel (template instance)
    in the built libraries, from ``cuobjdump -sass``; empty where the
    toolkit has no cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return {}
    out: dict[str, int] = {}
    for lib in cuda_lib.LIBRARIES:
        text = subprocess.run([exe, "-sass", cuda_lib._so_path(lib)],
                              capture_output=True, text=True,
                              timeout=120).stdout
        name = None
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = f"{lib}:{_kernel_name(m.group(1))}"
                out[name] = 0
            elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
                out[name] += 1
    return out


def earlier_ms(table: dict, key, seen: dict) -> str:
    """The earlier kernel's time for the n-th call of this shape (run
    P2-E), or why there is none."""
    n = seen.get(key, 0)
    seen[key] = n + 1
    times = table.get(key, [])
    return (f"earlier kernel (P2-E) {times[n]:.4f} ms" if n < len(times)
            else "no earlier time for this shape")


def check_edges(dev, fm, genome: str, card: str) -> None:
    """K1 and K2 at their edges, at the main path's widths, held against
    the plain versions on the card (tolerance 0)."""
    Lq = 160
    n = 0
    for w, M in ((1, 3072), (20, 3069), (57, 3072), (128, 3069)):
        args = k1_edge_inputs(dev, M, Lq, Lq + w + 1, w, seed=w)
        for zdrop in (0, 100):
            check_k1(args, w, zdrop, f"edge M={M}")
            n += 1
    log(f"K1 edge phase: {n} calls (M 3072/3069, w in {{1, 20, 57, 128}}, "
        "zdrop in {0, 100}; lanes with qlen = 0, tlen < w, tlen = Lt, "
        "tlen > Lt, h0 < 6): bit-equal (tolerance 0)")
    B = 4096
    cases = [  # (L, C, p3_seeds, max_rounds, step_cap)
        (160, 1, 8, 160, 656), (160, 16, 8, 160, 656),
        (160, 16, 0, 160, 40),          # truncates: n_dropped
        (160, 1, 0, 1, 328),            # the re-seed call's shape
        (1024, 8, 8, 1024, 4 * 1024 + 16)]
    for L, C, p3, rounds, cap in cases:
        reads, lens, active = edge_read_batch(genome, B, L, seed=L + C)
        rng = np.random.default_rng(C)
        x0 = (rng.integers(0, L, B) if rounds == 1 else np.zeros(B))
        mi = (rng.integers(1, 4, B) if rounds == 1 else np.ones(B))
        kw = dict(reads=reads, lens=lens, x0=x0.astype(np.int32),
                  min_intv=mi.astype(np.int32), active=active)
        kw = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in kw.items()}
        kw.update(max_seeds=16 if rounds > 1 else 4, min_seed_len=19, C=C,
                  max_rounds=rounds, step_cap=cap, p3_seeds=p3,
                  p3_max_intv=20)
        keys = K2_KEYS_BASE + (K2_KEYS_P3 if p3 else ())
        got = fm_cuda.smem_machine_cuda(fm, **kw)
        want = _smem_machine(fm, **kw)
        err = max_abs_diff(got, want, keys)
        dropped = int(want["n_dropped"].sum())
        if err or (cap == 40 and dropped == 0):
            raise AssertionError(f"K2 edge L={L} C={C} p3={p3} cap={cap}: "
                                 f"max |diff| {err}, {dropped} dropped")
        log(f"K2 edge B={B} L={L} C={C} p3={p3} rounds={rounds} cap={cap}: "
            f"bit-equal (tolerance 0; {dropped} lanes dropped, "
            f"{int((~kw['active']).sum())} inactive) [{card}]")


def bound_fields(bounds) -> dict:
    """bound_ms (mean over the calls, as ms is) and bound_by (what bounds
    the call with the largest bound)."""
    return dict(bound_ms=float(np.mean([b for b, _ in bounds])),
                bound_by=max(bounds)[1])


# ---------------------------------------------------------------------------
# recording the kernels' main-path inputs
# ---------------------------------------------------------------------------

class Recorder:
    """Wraps the two kernel launchers to keep each call's inputs and
    what the kernel returned."""

    def __init__(self):
        self.k1: list = []
        self.k2: list = []
        self._orig = (sw_cuda.extend_batch_banded_cuda,
                      fm_cuda.smem_machine_cuda)

    def __enter__(self):
        o1, o2 = self._orig

        def k1(*a, **kw):
            args = tuple(x.clone() for x in a[:5])
            out = o1(*a, **kw)
            self.k1.append((args, a[5:], kw,
                            {k: v.clone() for k, v in out.items()}))
            return out

        def k2(fm, *a, **kw):
            args = tuple(x.clone() if torch.is_tensor(x) else x for x in a)
            out = o2(fm, *a, **kw)
            self.k2.append((fm, args, kw,
                            {k: v.clone() for k, v in out.items()}))
            return out

        sw_cuda.extend_batch_banded_cuda = k1
        fm_cuda.smem_machine_cuda = k2
        return self

    def __exit__(self, *exc):
        sw_cuda.extend_batch_banded_cuda, fm_cuda.smem_machine_cuda = \
            self._orig


def k1_call_kwargs(rec):
    args, pos, kw, _ = rec
    names = ("o_del", "e_del", "o_ins", "e_ins", "match", "mismatch",
             "zdrop", "band")
    kw = dict(zip(names, pos), **kw)
    return args, kw


def k2_call_kwargs(rec):
    fm, a, kw, _ = rec
    names = ("reads", "lens", "x0", "min_intv", "active", "max_seeds",
             "min_seed_len", "C", "max_rounds", "step_cap", "p3_seeds",
             "p3_max_intv")
    return fm, dict(zip(names, a), **kw)


K2_KEYS_BASE = ("qbeg", "qend", "intv_l", "intv_sz", "n_seeds", "n_dropped")
K2_KEYS_P3 = ("p3_qbeg", "p3_qend", "p3_intv_l", "p3_intv_sz", "p3_n")


def k2_bound_ms(fm, kw, work) -> tuple[float, str]:
    """Roofline bound of one K2 call (``roof_ms``) over the
    bi-extensions and rank words these inputs need (``work`` is the
    plain machine's ``count_work`` output)."""
    reads = kw["reads"]
    B = reads.shape[0]
    nbytes = fm.blocks.numel() * 4 + reads.numel() + 4 * 4 * B + B \
        + (4 * kw["max_seeds"] + 2) * 4 * B \
        + (4 * kw.get("p3_seeds", 0) + 1) * 4 * B
    ops = K2_OPS_PER_EXT * int(work["exts"].sum()) \
        + K2_OPS_PER_WORD * int(work["rank_words"].sum())
    return roof_ms(nbytes, ops)


def dependent_load_ns(fm, dev, gen) -> float:
    """ns per dependent load through a table of K2's block rows: one
    thread chases a random single cycle over as many 48-byte rows as
    the FM-index has (so the same L1/L2 footprint), after one pass that
    touches every row; the slope of two chase lengths removes the
    launch cost."""
    rows, width = fm.blocks.shape
    perm = gen.permutation(rows)
    nxt = np.zeros((rows, width), np.int32)
    nxt[perm, 0] = np.roll(perm, -1)
    table = torch.from_numpy(nxt).to(dev)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    start = int(np.flatnonzero(perm == 0)[0])
    fm_cuda.load_chase(table, rows, out)
    torch.cuda.synchronize()
    if int(out[0]) != int(perm[(start + rows) % rows]):
        raise AssertionError("load_chase: wrong end of the chain")
    n1, n2 = 10_000, 210_000
    ms1 = cuda_ms(lambda: fm_cuda.load_chase(table, n1, out), 3)
    ms2 = cuda_ms(lambda: fm_cuda.load_chase(table, n2, out), 3)
    return 1e6 * (ms2 - ms1) / (n2 - n1)


# ---------------------------------------------------------------------------
# where the time goes
# ---------------------------------------------------------------------------

class StageTimer:
    """Times the pipeline's stages on the host clock, synchronising the
    card around each call (a diagnostic run: it removes any overlap)."""

    TARGETS = (   # (module, class or None, function, label)
        ("seqlib_tpu_torch.align.device_pipeline", None, "seed_and_locate",
         "seed: K2 + re-seed + SA locate"),
        ("seqlib_tpu_torch.align.device_pipeline", None, "chain_device",
         "chain (plain torch)"),
        ("seqlib_tpu_torch.align.device_pipeline", None, "extend_chains",
         "extend: K1 (adaptive) + windows"),
        ("seqlib_tpu_torch.align.device_full", None, "global_and_traceback",
         "global DP + traceback (plain torch)"),
        ("seqlib_tpu_torch.align.aligner", "BWAAligner",
         "_hits_cols_from_full", "host: fetch, MAPQ, columns"),
        ("seqlib_tpu_torch.native", None, "bam_encode_hits",
         "host: native SAM emission"),
    )

    def __init__(self):
        self.ms: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self._saved = []

    def __enter__(self):
        import importlib
        for mod, cls, attr, label in self.TARGETS:
            owner = importlib.import_module(mod)
            if cls:
                owner = getattr(owner, cls)
            orig = getattr(owner, attr)
            self._saved.append((owner, attr, orig))
            self.ms[label] = 0.0
            self.calls[label] = 0

            def timed(*a, _orig=orig, _label=label, **kw):
                torch.cuda.synchronize()
                t0 = time.time()
                out = _orig(*a, **kw)
                torch.cuda.synchronize()
                self.ms[_label] += 1e3 * (time.time() - t0)
                self.calls[_label] += 1
                return out

            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)


def profile_batch(aln, batch, card: str) -> None:
    """torch.profiler over one batch: device kernel time, its share of
    the batch's wall time, and the top kernels.  A profiler that records
    no device events says so; any other profiler failure fails the run."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        aln.align_batch_bam([s for _, s in batch], [n for n, _ in batch],
                            sam=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        log(f"profiler: no device events recorded; device busy share not "
            f"measured [{card}]")
        return
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name: dict[str, list] = {}
    for e in kern:
        v = by_name.setdefault(e.name, [0.0, 0])
        v[0] += e.time_range.elapsed_us() / 1e3
        v[1] += 1
    log(f"profiler: {len(kern)} kernel launches, {busy:.1f} ms of device "
        f"time in a {1e3 * wall:.1f} ms batch (traced): device busy "
        f"{100 * busy / (1e3 * wall):.1f}% [{card}]")
    for k, (ms, n) in sorted(by_name.items(), key=lambda t: -t[1][0])[:10]:
        log(f"  {k[:64]:64s} {ms:8.2f} ms x{n}")


def check_recorded(rec: Recorder, what: str) -> None:
    """What each recorded K1 and K2 call returned on the path, held
    against the plain version on the same inputs (tolerance 0)."""
    k1_err = 0
    shapes = set()
    for r in rec.k1:
        args, kw = k1_call_kwargs(r)
        k1_err = max(k1_err, max_abs_diff(r[3], extend_batch(*args, **kw)))
        shapes.add((args[0].shape[0], args[0].shape[1], args[2].shape[1],
                    kw["band"]))
    k2_err = 0
    for r in rec.k2:
        fm, kw = k2_call_kwargs(r)
        keys = K2_KEYS_BASE + (K2_KEYS_P3 if kw.get("p3_seeds") else ())
        k2_err = max(k2_err, max_abs_diff(r[3], _smem_machine(fm, **kw),
                                          keys))
    if k1_err or k2_err:
        raise AssertionError(f"{what}: kernel differs from plain (K1 max "
                             f"|diff| {k1_err}, K2 {k2_err})")
    log(f"{what}: K1 ({len(rec.k1)} calls, (M, Lq, Lt, w) in "
        f"{sorted(shapes)}) and K2 ({len(rec.k2)} calls, B = "
        f"{sorted({r[1][0].shape[0] for r in rec.k2})}) bit-equal to their "
        "plain versions on the path's own inputs (tolerance 0)")


def check_overflow_path(dev, card: str) -> None:
    """The 1000-read repeat corpus as one chunk through ``align_batch``
    (counters reset just before, read just after): the classic rerun
    must reproduce the JAX package's golden SAM, and the native path's
    SAM must equal the records' ``to_sam`` lines."""
    genome = make_repeat_genome()
    reads = make_repeat_reads(genome)
    idx = FMIndex.construct([("rep1", genome)])
    aln = BWAAligner(idx, device=dev)
    seqs, names = [s for _, s in reads], [n for n, _ in reads]
    torch.cuda.synchronize()
    with Recorder() as rec:
        cuda_lib.reset_launches()
        t0 = time.time()
        recs = aln.align_batch(seqs, names)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(cuda_lib.LAUNCHES)
    fallback = aln.stats["fused_overflow_fallback"]
    log(f"overflow path: {len(reads)} reads as one chunk through align_batch"
        f" in {wall:.2f} s; fused_overflow_fallback = {fallback}; launches "
        f"{launches} [{card}]")
    if fallback != 1:
        raise AssertionError(f"overflow path: fused_overflow_fallback = "
                             f"{fallback}, expected 1")
    for k in cuda_lib.MAIN_PATH:
        if launches[k] <= 0:
            raise AssertionError(f"overflow path: kernel {k} not launched")
    check_recorded(rec, "overflow path")
    hdr = idx.header_from_index()
    lines = [r.to_sam(hdr) for rs in recs for r in rs]
    with open(GOLDEN_REPEAT) as f:
        want = [l for l in f.read().splitlines() if not l.startswith("#")]
    if lines != want:
        bad = next(i for i, (a, b) in enumerate(zip(lines + [""], want + [""]))
                   if a != b)
        raise AssertionError(f"overflow path: SAM differs from {GOLDEN_REPEAT}"
                             f" ({len(lines)} vs {len(want)} lines; first "
                             f"difference at line {bad})")
    log(f"overflow path: align_batch SAM == {GOLDEN_REPEAT} byte for byte "
        f"({len(lines)} records)")
    payload, counts = aln.align_batch_bam(seqs, names, sam=True)
    if payload.decode() != "".join(l + "\n" for l in lines) \
            or counts.tolist() != [len(rs) for rs in recs]:
        raise AssertionError("overflow path: align_batch_bam(sam=True) "
                             "differs from the records' to_sam lines")
    log("overflow path: align_batch_bam(sam=True) == the records' to_sam "
        f"lines ({len(payload)} bytes; fallback counted "
        f"{aln.stats['fused_overflow_fallback'] - 1} more times)")


def main() -> int:
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = smi_name_power()
    log(f"device: {name} capability {torch.cuda.get_device_capability(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {card}")

    # ---- build ------------------------------------------------------------
    t0 = time.time()
    reports = cuda_lib.build_all()
    for k, rep in reports.items():
        for kern, regs, frame, st, ld in ptxas_report(rep):
            log(f"ptxas[{k}]: {kern}: {regs} registers, stack frame {frame}"
                f" B, spill stores {st} B, spill loads {ld} B")
    for k, n in sass_counts().items():
        log(f"sass: {k}: {n} instructions")
    log(f"build: {time.time() - t0:.1f} s for {len(reports)} kernel "
        f"libraries ({', '.join(reports)})")

    # ---- reference, reads, index --------------------------------------------
    t0 = time.time()
    genome = make_genome(GENOME_BP, seed=7)
    reads = simulate_reads(genome, BATCH * N_BATCHES, seed=11,
                           length=READ_BP)
    idx = FMIndex.construct([("sim_chr", genome)])
    aln = BWAAligner(idx, device=dev)
    log(f"reference {GENOME_BP} bp, {len(reads)} reads, index + upload "
        f"{time.time() - t0:.1f} s")
    batches = [reads[i:i + BATCH] for i in range(0, len(reads), BATCH)]

    # ---- one batch on the card, recording kernel inputs ---------------------
    b0 = batches[0]
    b1 = batches[1 % len(batches)]
    with Recorder() as rec:
        t0 = time.time()
        aln.align_batch_bam([s for _, s in b0], [n for n, _ in b0], sam=True)
        torch.cuda.synchronize()
        log(f"warm-up batch: {time.time() - t0:.2f} s; recorded "
            f"{len(rec.k1)} K1 and {len(rec.k2)} K2 calls")

    gen = np.random.default_rng(2024)
    kernels = {}

    # ---- K1 ------------------------------------------------------------------
    M, Lq = 3072, 160
    for w in (32, 100):
        args = k1_inputs(gen, M, Lq, Lq + w + 1, near=0.5, empty=0.05,
                         dev=dev)
        for zdrop in (0, 100):
            check_k1(args, w, zdrop, "synthetic")
    log("K1 synthetic M=3072 L=160 w in {32,100} zdrop in {0,100}: "
        "bit-equal (tolerance 0)")
    check_adaptive(gen, dev)
    check_edges(dev, rec.k2[0][0], genome, card)
    k1_ms, k1_ev, k1_plain, k1_bound, k1_err, k1_shapes, k1_one = \
        [], [], [], [], 0, set(), []
    for r in rec.k1:
        args, kw = k1_call_kwargs(r)
        got = sw_cuda.extend_batch_banded_cuda(*args, **kw)
        want = extend_batch(*args, return_rows=True, **kw)
        k1_err = max(k1_err, max_abs_diff(got, want))
        k1_ms.append(device_ms(
            lambda: sw_cuda.extend_batch_banded_cuda(*args, **kw), 5))
        # the lane with the most rows, alone on the card: one warp's
        # latency per row, against the whole call's time
        m = int(torch.argmax(want["rows"]))
        one = [a[m:m + 1] for a in args]
        k1_one.append((device_ms(
            lambda: sw_cuda.extend_batch_banded_cuda(*one, **kw), 5),
            int(want["rows"][m])))
        k1_ev.append(cuda_ms(
            lambda: sw_cuda.extend_batch_banded_cuda(*args, **kw), 5))
        k1_plain.append(cuda_ms(lambda: extend_batch(*args, **kw), 1))
        k1_bound.append(k1_bound_ms(args, kw["band"], want["rows"]))
        k1_shapes.add((tuple(args[0].shape), tuple(args[2].shape),
                       kw["band"]))
    if k1_err:
        raise AssertionError(f"K1 differs on main-path inputs ({k1_err})")
    log(f"K1 main-path inputs ({len(rec.k1)} calls, shapes {sorted(k1_shapes)}): "
        "bit-equal (tolerance 0)")
    seen: dict = {}
    for r, ms, ev, pm, bd, (ms1, rows1) in zip(rec.k1, k1_ms, k1_ev, k1_plain,
                                              k1_bound, k1_one):
        args, kw = k1_call_kwargs(r)
        M = args[0].shape[0]
        log(f"  K1 M={M} w={kw['band']}: {ms:.4f} ms device time, "
            f"{earlier_ms(P2E_K1_MS, (M, kw['band']), seen)} "
            f"({ev:.3f} ms/call with the wrapper; plain {pm:.1f} ms, "
            f"bound {bd[0]:.4f} ms, {bd[1]}; its longest lane alone "
            f"{ms1:.4f} ms for {rows1} rows = {1e3 * ms1 / max(rows1, 1):.3f}"
            f" us a row) [{card}]")
    kernels["sw_extend"] = dict(
        name="sw_extend_banded", route="cuda",
        source="seqlib_tpu_torch/csrc/sw_extend.cu",
        replaces="seqlib_tpu/ops/sw_pallas.py:174",
        max_abs_err=k1_err, ms=float(np.mean(k1_ms)),
        event_ms=float(np.mean(k1_ev)), plain_ms=float(np.mean(k1_plain)),
        library_ms=None,
        **bound_fields(k1_bound))

    # ---- K2 ------------------------------------------------------------------
    load_ns = dependent_load_ns(rec.k2[0][0], dev, gen)
    log(f"dependent load through {rec.k2[0][0].blocks.shape[0]} block rows "
        f"(one-thread chase, __ldg): {load_ns:.1f} ns [{card}]")
    k2_ms, k2_ev, k2_plain, k2_bound, k2_err = [], [], [], [], 0
    seen = {}
    for r in rec.k2:
        fm, kw = k2_call_kwargs(r)
        keys = K2_KEYS_BASE + (K2_KEYS_P3 if kw.get("p3_seeds") else ())
        got = fm_cuda.smem_machine_cuda(fm, **kw)
        t0 = time.time()
        want = _smem_machine(fm, **kw)
        torch.cuda.synchronize()
        k2_plain.append(1e3 * (time.time() - t0))
        k2_err = max(k2_err, max_abs_diff(got, want, keys))
        work = _smem_machine(fm, **kw, count_work=True)
        k2_ms.append(device_ms(lambda: fm_cuda.smem_machine_cuda(fm, **kw),
                               5))
        k2_ev.append(cuda_ms(lambda: fm_cuda.smem_machine_cuda(fm, **kw), 5))
        k2_bound.append(k2_bound_ms(fm, kw, work))
        # the lane with the most steps, alone on the card
        m = int(torch.argmax(work["steps"]))
        kw1 = {k: v[m:m + 1] if torch.is_tensor(v) else v
               for k, v in kw.items()}
        ms1 = device_ms(lambda: fm_cuda.smem_machine_cuda(fm, **kw1), 5)
        steps1 = int(work["steps"][m])
        n_ext = int(work["exts"].sum())
        dep_ms = 1e-6 * load_ns * int(work["rounds"].max())
        log(f"  K2 B={kw['reads'].shape[0]} L={kw['reads'].shape[1]} "
            f"S={kw['max_seeds']} p3={kw.get('p3_seeds', 0)} "
            f"cap={kw['step_cap']}: {k2_ms[-1]:.4f} ms device time, "
            f"{earlier_ms(P2E_K2_MS, (kw['reads'].shape[0], kw['max_seeds']), seen)} "
            f"({k2_ev[-1]:.3f} ms/call with the wrapper; plain "
            f"{k2_plain[-1]:.0f} ms, bound {k2_bound[-1][0]:.4f} ms, "
            f"{k2_bound[-1][1]}; "
            f"dependent-load bound {dep_ms:.4f} ms) [{card}]")
        log(f"    work: mean steps {float(work['steps'].float().mean()):.1f}, "
            f"{n_ext} bi-extensions, "
            f"{int(work['rank_words'].sum()) / max(2 * n_ext, 1):.2f} words "
            f"per rank, longest lane {int(work['rounds'].max())} dependent "
            f"rounds; the lane with the most steps alone: {ms1:.4f} ms for "
            f"{steps1} steps = {1e3 * ms1 / max(steps1, 1):.3f} us a step, "
            f"{1e6 * ms1 / max(steps1, 1) / load_ns:.1f} dependent loads")
    if k2_err:
        raise AssertionError(f"K2 differs on main-path inputs ({k2_err})")
    # a step cap that truncates lanes: n_dropped must agree too
    fm, kw = k2_call_kwargs(rec.k2[0])
    kw = dict(kw, step_cap=40)
    got = fm_cuda.smem_machine_cuda(fm, **kw)
    want = _smem_machine(fm, **kw)
    keys = K2_KEYS_BASE + (K2_KEYS_P3 if kw.get("p3_seeds") else ())
    if max_abs_diff(got, want, keys) or int(want["n_dropped"].sum()) == 0:
        raise AssertionError("K2 truncating step cap: mismatch or no "
                             "truncated lane")
    log(f"K2 main-path inputs ({len(rec.k2)} calls: collect + pass 3, "
        "re-seed) and a truncating step cap: bit-equal (tolerance 0)")
    kernels["smem_machine"] = dict(
        name="smem_machine", route="cuda",
        source="seqlib_tpu_torch/csrc/smem_machine.cu",
        replaces="seqlib_tpu/ops/fm_pallas.py:77",
        max_abs_err=k2_err, ms=float(np.mean(k2_ms)),
        event_ms=float(np.mean(k2_ev)), plain_ms=float(np.mean(k2_plain)),
        library_ms=None,
        **bound_fields(k2_bound))

    # ---- main path -------------------------------------------------------------
    class Read:
        __slots__ = ("name", "seq")

        def __init__(self, n, s):
            self.name, self.seq = n, s

    stream = [Read(n, s) for n, s in reads]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.time()
    outs = list(aln.align_stream_bam(iter(stream), batch_size=BATCH,
                                     sam=True))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    n_reads = sum(len(c) for c, _, _ in outs)
    log(f"main path: {n_reads} reads in {len(outs)} batches through "
        f"align_stream_bam on {name}: {wall:.2f} s = "
        f"{n_reads / wall:.0f} reads/s [{card}]")
    log(f"launches on the main path: {launches} "
        f"(per batch: { {k: v / len(outs) for k, v in launches.items()} })")
    for k in cuda_lib.MAIN_PATH:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main "
                                 "path")
    if n_reads != len(reads):
        raise AssertionError("the stream lost reads")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.0f}"
        f" MiB [{card}]")

    sam_all = "".join(p.decode() for _, p, _ in outs)
    ok, with_primary = placement_rate(sam_all)
    rate = ok / len(reads)
    log(f"placement: {ok}/{len(reads)} reads ({100 * rate:.2f}%) have their "
        f"primary within 5 bp of the simulated position; {with_primary} "
        "have a primary")
    if rate < 0.98:
        raise AssertionError(f"placement rate {rate:.4f} < 0.98")

    t0 = time.time()
    cpu = BWAAligner(idx, device="cpu")
    c_payload, c_counts = cpu.align_batch_bam(
        [s for _, s in b0], [n for n, _ in b0], sam=True)
    _, g_payload, g_counts = outs[0]
    if c_payload != g_payload or not np.array_equal(c_counts, g_counts):
        raise AssertionError("first batch: GPU and CPU SAM differ")
    log(f"first batch: GPU SAM == CPU SAM byte for byte ({len(g_payload)} "
        f"bytes, {int(g_counts.sum())} records; CPU run "
        f"{time.time() - t0:.1f} s)")

    # ---- where one batch's time goes ------------------------------------------
    with StageTimer() as st:
        t0 = time.time()
        aln.align_batch_bam([s for _, s in b1], [n for n, _ in b1], sam=True)
        torch.cuda.synchronize()
        wall_b = time.time() - t0
    log(f"stages of one {BATCH}-read batch (host clock, synchronised; "
        f"{1e3 * wall_b:.1f} ms in all) [{card}]:")
    for k, v in st.ms.items():
        log(f"  {k:34s} {v:8.1f} ms x{st.calls[k]}")
    profile_batch(aln, b1, card)

    for k, v in kernels.items():
        v["launches"] = int(launches[k])

    # ---- overflow path and object API ----------------------------------------
    check_overflow_path(dev, card)

    # ---- K3, K4, K5 on the extension bench path --------------------------------
    t0 = time.time()
    bench = bench_sw.run(dev, log=log)
    for k in bench_sw.RECT_KERNELS:
        kernels[k] = bench[k]
    log(f"extension bench (checks + timing): {time.time() - t0:.1f} s; "
        "launches on the bench path: "
        f"{ {k: bench[k]['launches'] for k in bench_sw.RECT_KERNELS} }")

    kl = [dict(name=v["name"], route=v["route"], source=v["source"],
               replaces=v["replaces"], launches=v["launches"],
               max_abs_err=v["max_abs_err"], ms=v["ms"],
               event_ms=v["event_ms"], plain_ms=v["plain_ms"],
               bound_ms=v["bound_ms"], bound_by=v["bound_by"],
               library_ms=v["library_ms"])
          for v in kernels.values()]
    log("kernels: " + ", ".join(
        f"{v['name']} launches={v['launches']} equal={v['max_abs_err'] == 0}"
        f" ms={v['ms']:.4f}" for v in kl))
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kl}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
