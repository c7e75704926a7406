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
   with the launch counters reset just before and read just after (no
   walk launch: the index has its full SA);
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
9. long reads: 128 simulated reads of 1.5-10 kb (0.2% substitutions,
   one 1-4 bp indel per kb, 10% with a 200-400 bp random 3' tail, both
   strands) on the main reference, in batches of 32 through
   ``align_batch`` (the long-read path) inside the kernel recorder,
   launch counters reset just before and read just after: the lanes of
   at most 4 kb of every recorded K1 call and the reads of at most 4 kb
   of every K2 call held against the plain version (tolerance 0) and
   timed beside their bound (the whole calls' device time beside); the
   first 8 reads of <= 3 kb against the
   port's CPU run, byte for byte; >= 98% placed within 5 bp of the
   simulated start of their genomic part; reads/s, bases/s, stage times
   and peak device memory;
10. pairs: 2 x 4096 simulated pairs (2 x 150 bp, insert 400 +- 40; mate
   2 of 2% mutated at period 8, so it has no seed) through
   ``align_pairs``, counters reset just before and read just after: the
   first 512 pairs against a CPU run given the card's insert-size
   statistics, byte for byte; >= 95% of the period-8 mates rescued
   within 20 bp, flagged proper; pairs/s and the proper-pair share;
11. bam: the main reference cut into chr1..chr3 (2.0, 1.6 and 1.0 Mbp;
   chr2's first 500 bases N) and indexed; the 32,768 main reads through
   ``align_stream_bam(sam=False)`` on the card into ``BamWriter(BAM).
   write_records_bytes`` (out.bam), read back with ``FastBamReader``,
   the primaries' reads realigned on the card, ``sort_by_position``,
   ``BamWriter`` with ``enable_indexing`` (out.sorted.bam + .bai) and 200
   region queries through ``BamReader.set_region`` and ``fetch_region``,
   counters reset just before and read just after: the first 512 reads'
   BAM bytes on the card == on the CPU, as read and as realigned;
   out.bam through ``BamReader`` == ``align_batch_bam(sam=True)`` line
   for line, ``FastBamReader`` == ``BamReader``; >= 99% of the MAPQ >= 20
   primaries keep contig and position; every region == the brute-force
   answer under each reader's rule, with the inline .bai and with
   ``build_index``'s; write MB/s (inside the stream, and the native and
   Python routes alone, in turns), records/s read, ms a region query,
   realign reads/s;
12. long edges: K1 at Lq 4095-6200 (w 32/100, zdrop 0/100) and 30,000
   (four lanes' codes past 227 KB of shared memory, read from global
   memory), K2 at L 12,289 and 60,000, each against its plain version
   on the card (tolerance 0) and timed;
13. assembly-local (configuration 3): 5,000 pairs of 2 x 150 bp (error
   rate 0.005) over the reference's first 50 kb through ``BFC`` (train,
   error_correct) and ``FermiAssembler.perform_assembly`` on the card,
   counters reset just before and read just after: exactly one contig,
   >= 99% of the window and an exact substring of it or of its reverse
   complement; corrected reads, contigs, unitig links and GFA text equal
   to the port's CPU run byte for byte; stage times, peak device memory,
   and one walk again under torch.profiler (launches, busy share);
14. cli: the bam phase's reference written to ref.fa; ``seqtools
   index`` (``cli.main``, in-process) writes bwa's five files;
   ``FMIndex.load`` (no full SA; the locate walks LF to the samples at
   interval 32) and the main reads through ``align_stream_bam`` on it;
   ``seqtools align -b`` of 4,096 reads, ``align -2`` of 1,024 of the
   paired phase's pairs and ``fml -f`` of the assembly-local window's
   reads, on the card, counters reset just before and read just after:
   the files == ``FMIndex.write`` of the constructed index, the loaded
   arrays == the constructed ones; the loaded index's BAM records == the
   bam phase's byte for byte, and GPU == CPU on 512 reads; the CLI's
   BAM == ``align_batch`` + ``mark_supplementary``; >= 98% of the pairs
   proper; fml's contig == the assembly-local phase's; the index,
   write and load times, reads/s loaded against constructed in turns,
   the locate's ms a batch and longest walk, the SA's bytes on the card
   and peak memory.  Then the LF-walk kernel (``csrc/sa_walk.cu``) on
   the loaded index: one 65,536-read batch (the benchmark's) aligned
   inside the kernel recorder, every walk call's positions, and the
   kernel's positions and steps on its ranks, held against the plain
   loop on the card (tolerance 0), and the batch's call timed (device
   ms a launch, ms with the wrapper, the plain loop's ms) beside its
   bound: the largest of the HBM stream, the L2 traffic at L2's read
   bandwidth measured on the index's rows, and the longest walk x the
   dependent-load latency;
15. records: the bam phase's sorted BAM (the main reads aligned on the
   card) through ``BamWriter(CRAM)`` with the reference attached (RR=1)
   and without, ``build_index`` (.crai), ``BamReader`` over each,
   RECORDS_REGIONS of the bam phase's regions through the .crai (each
   decodes whole containers in Python: 0.5-0.8 s), ``seqtools align
   -C`` of the cli phase's 4,096 reads on the card, ``GRC`` tiles of the
   header and every alignment's overlaps (``count_overlaps_batch``), a
   ``ReadFilterCollection`` JSON script (a BED region with MAPQ and clip
   ranges and a subsample rate, a motif file), ``STCoverage`` of chr1's
   first COV_WINDOW bases, ``BamStats`` and a ``SeqPlot`` of one 1 kb
   window, counters reset just before and read just after: each CRAM
   decodes to the BAM's records field for field; each region == the
   BAM's answer; the CLI's CRAM == the cli phase's BAM record for
   record; the overlap counts == a brute-force count; each filter
   decision == the rules' predicates; the coverage and its bedgraph ==
   a numpy difference-array coverage; the stats count every record;
   every read inside the plotted window drawn once; records/s written
   and read, bytes a record, ms a query, the times of each step;
16. bfc-genome: BFC on the whole reference at 30x (460,000 pairs of 2 x
   150 bp, error rate 0.005) on the card, counters reset just before and
   read just after: the card's k-mer table equals the port's CPU count,
   4,096 walked rows equal a CPU walk with the card's table, and the
   reads equal to their error-free truth (from the read names) reach
   ``before + 0.5 (n - before)`` and 90%; corrected reads/s and
   bases/s, stage times, unique k-mers, kcov, min_cov, peak memory, and
   one traced walk;
17. wide (a reference past 2^31 cannot be built in this script's time,
   so it is shown three ways): K2's int64 instantiation against its
   plain version on the card, bit for bit, on two synthetic BWTs of
   2^31 + 2^24 bases built on the card (random codes with seeded shares,
   the checkpoints from their cumulative counts; one uniform, one 99.7%
   T so its T checkpoints pass 2^31), 4,096 seeded 150 bp reads each,
   the collect call (pass 3 fused) and a re-seed call, with interval
   starts past 2^31 among the seeds; the biased-checkpoint index
   (rank'(c, k) = rank(c, k) + bias[c]) of the main reference through
   the plain rank, rank4 and bi-extension on the card against the host
   index's int64 ranks plus the bias; the main path with ``wide=True``
   (int64 checkpoint rows, K2's int64 instance, an int64 region block):
   one batch recorded, each K1 and K2 call held against its plain
   version and timed, then the 32,768 reads through
   ``align_stream_bam`` with the counters reset just before and read
   just after, SAM == the narrow path's byte for byte, reads/s and peak
   memory beside the narrow path's; a sharded index of the bam phase's
   chr1..chr3 (two shards: chr1 | chr2 + chr3) written with
   ``ShardedFMIndex.write`` and 4,096 reads through ``seqtools align``
   on the ``.shards`` prefix, counters reset just before and read just
   after: each read's records == the single index's in flag, place,
   MAPQ, CIGAR, NM and AS, or, where its primary is one of several
   equal-score hits, the same alignments with another of them primary
   (the global keys order such hits differently, as in the JAX
   package); reads/s;
18. parallel: ``make_mesh()`` over every visible card and a mesh of two
   entries on cuda:0; through each, the first 8,192 main reads through
   ``align_stream_bam`` (counters reset just before and read just
   after; SAM == the main path's byte for byte) and the 1000-read
   repeat corpus through ``align_batch`` (it overflows, so the classic
   path runs, its narrow global DP split over the mesh; records == the
   golden SAM); on the two-entry mesh one batch's K1 and
   K2 calls against their plain versions (tolerance 0);
   ``sharded_seed_step`` on 1024 main reads and ``sharded_extend_step``
   on bench.py's 1024 lanes at band 0 (K3) and band 100 (K1), each ==
   the same call on one device == the plain version (tolerance 0);
   ``measure_scaling`` at sizes [1, 2] of one card (replicas on one
   card, not multi-GPU scaling); two ranks of
   ``python -m seqlib_tpu_torch.parallel.multihost`` on cuda:0 joined by
   gloo on a free localhost port, each with a timeout, each aligning its
   ``host_shard`` of the 8,192 reads into a BAM part: both ranks' summed
   totals agree and equal the parts' sums, and the parts merged by read
   name == one process's records; reads/s per rank and combined, peak
   memory per rank; ``dryrun_multichip(device_count)``;
19. rectangle kernels K3, K4, K5 (``bench_sw.run``): first the DPX
   probe line (clocks a scheduler per warp instruction of the s16x2 and
   int32 add-max, PRMT, and the s16x2 forms' edge semantics); then each
   kernel held against its plain version on the card, tolerance 0, on
   bench.py's inputs, the variant sweep's and a set of short and empty
   lanes, at zdrop 0 and 100 (K5: 100 only), and on the stop-row lanes
   (``bench_sw.rect_stop_inputs``: z-drop stops on rows 0, 1, P - 2 ..
   P and 2P of each pipeline depth P of K4 and K5, ties, empty and
   oversized lanes) at Lt 31, 60, 250 and 1023, zdrop also 7 and 10^6;
   then timed on the extension bench path (device time per launch and
   per-call wrapper time, as for K1 and K2, beside the earlier layouts'
   times (PERF.md), and each variant's longest lane alone: rows,
   pipeline steps, ns a step), whose launches they report;
20. one JSON line of all six kernels' numbers, each with its launches
   on each path it has (``by_path``: K1, K2 and the walk main,
   overflow, long, paired, bam, cli, records, wide, sharded, mesh,
   multihost, the walk 0 on every path over a full SA; K3 mesh; K3-K5
   bench; all six assembly, where no TPU-kernel counterpart runs), K1's
   and K2's long and wide paths with their mean device ms and bound.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from seqlib_tpu_torch import bench_sw
from seqlib_tpu_torch.align import BWAAligner
from seqlib_tpu_torch.assembly import BFC, FermiAssembler
from seqlib_tpu_torch.assembly.bfc import encode_reads
from seqlib_tpu_torch.core import (FSECONDARY, FSUPPLEMENTARY, FUNMAP,
                                   GenomicRegion, sort_by_position)
from seqlib_tpu_torch.core.seq import revcomp
from seqlib_tpu_torch.core.unaligned import UnalignedSequence
from seqlib_tpu_torch.bench_sw import (HBM_BYTES_PER_S, band_cells_needed,
                                       cuda_ms, device_ms, k1_edge_inputs,
                                       k1_long_inputs, max_abs_diff, roof_ms,
                                       smi_name_power)
from seqlib_tpu_torch.index import FMIndex
from seqlib_tpu_torch.io import BAM, CRAM, BamReader, BamWriter, \
    BgzfReader, BgzfWriter, RefGenome
from seqlib_tpu_torch.io.bam import encode_record, read_bam_header, \
    read_record
from seqlib_tpu_torch.io.fast_bam import FastBamReader, fetch_region
from seqlib_tpu_torch.io.sam import format_sam_line
from seqlib_tpu_torch.ops import cuda_lib, fm_cuda, kmer, sw_cuda
from seqlib_tpu_torch.ops import fm as fm_ops
from seqlib_tpu_torch.ops.fm import DeviceFMIndex, _sa_walk, _smem_machine
from seqlib_tpu_torch.ops.sw import extend_batch
from seqlib_tpu_torch.sim import (edge_read_batch, make_genome,
                                  make_repeat_genome, make_repeat_reads,
                                  placement_rate, simulate_long_reads,
                                  simulate_pairs, simulate_reads)

GENOME_BP = 4_600_000
BATCH = 4096
N_BATCHES = 8
READ_BP = 150
LONG_READS = 128                   # long-read phase: 1.5-10 kb reads
LONG_BATCH = 32
# K1 lanes and K2 reads of the long phase held against the plain versions
# (which last as long as their longest lane); longer ones are aligned and
# checked by placement only
LONG_CHECK_BP = 4_000
PAIR_BATCH = 4096                  # paired phase: 2 x 4096 pairs
PAIR_BATCHES = 2
PAIR_CHECK = 512                   # pairs held against the CPU run
BAM_CUTS = (2_000_000, 3_600_000)  # bam phase: chr1..chr3 of 2.0, 1.6, 1.0 Mbp
BAM_NRUN = 500                     # N at the start of chr2
BAM_CHECK = 512                    # reads held against the CPU run
BAM_REGIONS = 200
CLI_ALIGN = 4096                   # cli phase: reads through `seqtools align`
CLI_PAIRS = 1024                   # pairs through `seqtools align -2`
CLI_CHECK = 512                    # reads held GPU against CPU, loaded index
WALK_READS = 65_536                # walk: one batch of the benchmark's size
WALK_REPS = 20                     # on the loaded index; its timed launches
RECORDS_REGIONS = 20               # records: the bam phase's first regions
COV_WINDOW = 200_000               # on the CRAM (each decodes its containers)
PLOT_WINDOW = 1_000
# K1 at long shapes (Lq, w, zdrop): across the 4096 rows of the JAX
# package's packed tie-break, and four lanes' codes across 48 KB (Lq
# 6200) and 227 KB (Lq 30,000) of shared memory; K2 at read lengths
# whose four reads cross 48 KB and 227 KB
K1_LONG_EDGES = [(Lq, w, z) for Lq in (4095, 4096, 4097, 6200)
                 for w in (32, 100) for z in (0, 100)] + [(30_000, 100, 100)]
K2_LONG_EDGES = (12_289, 60_000)
K2_EDGE_CAP = 2000                 # steps a lane of those reads may take
WIDE_SYNTH_BP = 2**31 + 2**24      # wide: a synthetic BWT past 2^31
WIDE_SYNTH_READS = 4096
# wide: base shares of the skewed synthetic BWT, whose T counts pass 2^31
WIDE_SKEW = (0.001, 0.001, 0.001, 0.997)
WIDE_BIAS = (3 << 30, (1 << 32) + 5, 1 << 31, (1 << 33) + 7)
SHARD_BP = 2_700_000               # sharded: chr1 | chr2 + chr3
SHARD_READS = 4096                 # reads through `seqtools align` on it
MESH_READS = 8192                  # parallel: main reads through each mesh
ASM_WINDOW = 50_000                # assembly-local: genome[0:50 kb], before
ASM_PAIRS = 5_000                  # the first planted repeat slot
BFC_PAIRS = GENOME_BP * 30 // (2 * READ_BP)   # bfc-genome: 30x of 2 x 150 bp
BFC_SAMPLE = 4096                  # walked rows held against a CPU walk
GOLDEN_REPEAT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "golden", "sam_repeat_1k.txt")
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
# the kernels whose launches each aligner path reports: K1 and K2 on every
# index, the walk on a loaded one (a sampled SA) only
PATH_KERNELS = cuda_lib.MAIN_PATH + ("sa_walk",)


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
    ops = bench_sw.OPS_PER_CELL * band_cells_needed(args, w, rows)
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
                name = f"{lib}:{cuda_lib.kernel_name(m.group(1))}"
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
    """Wraps the three kernel launchers of the aligner (K1, K2 and the
    LF walk) to keep each call's inputs and what the kernel returned."""

    def __init__(self):
        self.k1: list = []
        self.k2: list = []
        self.walk: list = []
        self._orig = (sw_cuda.extend_batch_banded_cuda,
                      fm_cuda.smem_machine_cuda, fm_cuda.sa_walk_cuda)

    def __enter__(self):
        o1, o2, o3 = self._orig

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

        def walk(fm, ranks, return_steps=False):
            pos, steps = o3(fm, ranks, return_steps)
            self.walk.append((fm, ranks.clone(), pos.clone()))
            return pos, steps

        sw_cuda.extend_batch_banded_cuda = k1
        fm_cuda.smem_machine_cuda = k2
        fm_cuda.sa_walk_cuda = walk
        return self

    def __exit__(self, *exc):
        (sw_cuda.extend_batch_banded_cuda, fm_cuda.smem_machine_cuda,
         fm_cuda.sa_walk_cuda) = self._orig


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
    S, P3 = kw["max_seeds"], kw.get("p3_seeds", 0)
    il = 8 if fm.wide else 4          # interval starts: int64 on a wide index
    nbytes = fm.blocks.numel() * fm.blocks.element_size() + reads.numel() \
        + 4 * 4 * B + B + (3 * S + 2) * 4 * B + S * il * B \
        + (3 * P3 + 1) * 4 * B + P3 * il * B
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


def l2_bytes_per_s(table: torch.Tensor) -> float:
    """L2's read bandwidth over ``table`` (the index's block rows: it
    stays in L2): ``fm_cuda.l2_read`` over the whole card, the slope of
    two repeat counts (which removes the launch cost)."""
    out = torch.zeros(1, dtype=torch.int32, device=table.device)
    n1, n2 = 10, 110
    ms1 = device_ms(lambda: fm_cuda.l2_read(table, n1, out), 5)
    ms2 = device_ms(lambda: fm_cuda.l2_read(table, n2, out), 5)
    return (n2 - n1) * table.numel() * table.element_size() \
        / (1e-3 * (ms2 - ms1))


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

    # the long-read path's stages (align_batch on reads over 1024 bp)
    LONG_TARGETS = (
        ("seqlib_tpu_torch.align.aligner", None, "seed_and_locate",
         "seed: K2 + re-seed + SA locate"),
        ("seqlib_tpu_torch.align.aligner", None, "chain_batch",
         "chain (host numpy)"),
        ("seqlib_tpu_torch.align.aligner", None, "extend_chains",
         "extend: K1 (adaptive) + windows"),
        ("seqlib_tpu_torch.align.device_pipeline", None,
         "global_and_traceback", "global DP + traceback (plain torch)"),
        ("seqlib_tpu_torch.align.aligner", "BWAAligner", "_assemble_records",
         "host: records"),
    )
    # the paired path's stages (align_pairs)
    PAIR_TARGETS = (
        ("seqlib_tpu_torch.align.aligner", "BWAAligner", "align_batch",
         "align_batch (both ends)"),
        ("seqlib_tpu_torch.align.pairing", None, "infer_isize_stats",
         "insert-size statistics (host)"),
        ("seqlib_tpu_torch.align.pairing", None, "rescue_candidates",
         "rescue: local SW (plain torch)"),
        ("seqlib_tpu_torch.align.pairing", None, "_rescued_records",
         "rescue: dedup, global DP, records"),
    )

    # BFC (train, the weak pre-scan, the spectrum walk) and assembly
    BFC_TARGETS = (
        ("seqlib_tpu_torch.assembly.bfc", "BFC", "train",
         "BFC.train: count on the card, host table"),
        ("seqlib_tpu_torch.assembly.bfc", None, "weak_reads_device",
         "BFC weak pre-scan"),
        ("seqlib_tpu_torch.assembly.bfc", None, "correct_reads_device",
         "BFC spectrum walk"),
    )
    ASM_TARGETS = BFC_TARGETS + (
        ("seqlib_tpu_torch.assembly.fermi", "FermiAssembler",
         "_kmer_filter", "assembly: k-mer read filter"),
        ("seqlib_tpu_torch.assembly.fermi", None, "find_overlaps",
         "assembly: overlaps (host numpy)"),
        ("seqlib_tpu_torch.assembly.fermi", "FermiAssembler", "_assemble",
         "assembly in all"),
    )

    def __init__(self, targets=TARGETS):
        self.targets = targets
        self.ms: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self._saved = []

    def __enter__(self):
        import importlib
        for mod, cls, attr, label in self.targets:
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


def traced(fn, what: str, card: str, top: int = 10):
    """torch.profiler over one call of fn(): device events, their time,
    its share of the call's wall time, and the top kernels.  Returns
    (device events, busy share) or None where the profiler records no
    device events (it says so); any other profiler failure fails the
    run."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        log(f"profiler: no device events recorded in {what}; device busy "
            f"share not measured [{card}]")
        return None
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name: dict[str, list] = {}
    for e in kern:
        v = by_name.setdefault(e.name, [0.0, 0])
        v[0] += e.time_range.elapsed_us() / 1e3
        v[1] += 1
    share = busy / (1e3 * wall)
    log(f"profiler: {len(kern)} device events (kernel launches and copies),"
        f" {busy:.1f} ms of device time in {what} of {1e3 * wall:.1f} ms "
        f"(traced): device busy {100 * share:.1f}% [{card}]")
    for k, (ms, n) in sorted(by_name.items(), key=lambda t: -t[1][0])[:top]:
        log(f"  {k[:64]:64s} {ms:8.2f} ms x{n}")
    return len(kern), share


def profile_batch(aln, batch, card: str) -> None:
    """torch.profiler over one main-path batch (``traced``)."""
    traced(lambda: aln.align_batch_bam([s for _, s in batch],
                                       [n for n, _ in batch], sam=True),
           "a batch", card)


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
    return launches


# ---------------------------------------------------------------------------
# long reads, pairs, and K1/K2 at long shapes
# ---------------------------------------------------------------------------

def _pad_cat(tensors, width: int, fill: int):
    """Row-concatenate 2-D code tensors, each padded to ``width`` columns."""
    out = []
    for x in tensors:
        pad = torch.full((x.shape[0], width - x.shape[1]), fill,
                         dtype=x.dtype, device=x.device)
        out.append(torch.cat([x, pad], dim=1))
    return torch.cat(out)


def plain_k1_grouped(calls):
    """The plain version of each K1 call, computed once for all calls of
    one (band, zdrop, penalties) over their lanes concatenated, each
    call's codes padded to the group's widest Lq and Lt.  Lanes are
    independent and padding past a lane's qlen and tlen is never read,
    which holds where qlen <= Lq and tlen <= Lt (checked: the long path's
    lanes are so by construction).  ``calls``: [(args, kw)]; returns each
    call's plain outputs (with "rows")."""
    groups: dict = {}
    for n, (args, kw) in enumerate(calls):
        q, ql, t, tl, _ = args
        if bool((ql > q.shape[1]).any()) or bool((tl > t.shape[1]).any()):
            raise AssertionError("plain_k1_grouped: qlen > Lq or tlen > Lt")
        groups.setdefault(tuple(sorted(kw.items())), []).append(n)
    out = [None] * len(calls)
    for key, idx in groups.items():
        args = [calls[n][0] for n in idx]
        lq = max(a[0].shape[1] for a in args)
        lt = max(a[2].shape[1] for a in args)
        cat = (_pad_cat([a[0] for a in args], lq, 4),
               torch.cat([a[1] for a in args]),
               _pad_cat([a[2] for a in args], lt, 4),
               torch.cat([a[3] for a in args]),
               torch.cat([a[4] for a in args]))
        want = extend_batch(*cat, return_rows=True, **dict(key))
        m0 = 0
        for n, a in zip(idx, args):
            m = a[0].shape[0]
            out[n] = {k: v[m0:m0 + m] for k, v in want.items()}
            m0 += m
    return out


def plain_k2_grouped(fm, calls):
    """The plain SMEM machine of each K2 call with ``count_work``,
    computed once for all calls of one (seeds, stack, pass 3, one round
    or all) over their reads concatenated, each padded with N to the
    group's longest L, under the group's largest max_rounds and
    step_cap.  The machine reads no code at or past a read's length, and
    a read ends within its length's rounds; a lane whose steps pass its
    own call's cap (the only place the group's cap could differ) sends
    that call to a run of its own.  ``calls``: [kw]; returns each call's
    plain outputs."""
    lane_keys = ("reads", "lens", "x0", "min_intv", "active")
    groups: dict = {}
    for n, kw in enumerate(calls):
        key = (kw["max_seeds"], kw["min_seed_len"], kw["C"],
               kw.get("p3_seeds", 0), kw.get("p3_max_intv", 20),
               kw["max_rounds"] == 1)
        groups.setdefault(key, []).append(n)
    out = [None] * len(calls)
    for idx in groups.values():
        kws = [calls[n] for n in idx]
        L = max(kw["reads"].shape[1] for kw in kws)
        cat = dict(kws[0])
        cat["reads"] = _pad_cat([kw["reads"] for kw in kws], L, 4)
        for k in lane_keys[1:]:
            cat[k] = torch.cat([kw[k] for kw in kws])
        cat["max_rounds"] = max(kw["max_rounds"] for kw in kws)
        cat["step_cap"] = max(kw["step_cap"] for kw in kws)
        want = _smem_machine(fm, **cat, count_work=True)
        b0 = 0
        for n, kw in zip(idx, kws):
            b = kw["reads"].shape[0]
            part = {k: v[b0:b0 + b] for k, v in want.items()}
            b0 += b
            if int(part["steps"].max()) > kw["step_cap"]:
                part = _smem_machine(fm, **kw, count_work=True)
            out[n] = part
    return out


def _k1_lanes_upto(args, got, check_bp):
    """A K1 call's lanes of query length <= check_bp (all where None),
    their codes cut to the longest such lane, and what the kernel
    returned for them; None where no lane qualifies."""
    if check_bp is None:
        return args, got
    q, ql, t, tl, h0 = args
    sel = torch.nonzero(ql <= check_bp).flatten()
    if sel.numel() == 0:
        return None
    lq = max(int(ql[sel].max()), 1)
    lt = max(int(tl[sel].max()), 1)
    return ((q[sel, :lq].contiguous(), ql[sel], t[sel, :lt].contiguous(),
             tl[sel], h0[sel]), {k: v[sel] for k, v in got.items()})


def _k2_reads_upto(kw, got, check_bp):
    """A K2 call's reads of length <= check_bp (all where None), cut to
    the longest such read, and what the kernel returned for them."""
    if check_bp is None:
        return kw, got
    sel = torch.nonzero(kw["lens"] <= check_bp).flatten()
    if sel.numel() == 0:
        return None
    L = max(int(kw["lens"][sel].max()), 1)
    sub = {k: v[sel] if torch.is_tensor(v) else v for k, v in kw.items()}
    sub["reads"] = sub["reads"][:, :L].contiguous()
    return sub, {k: v[sel] for k, v in got.items()}


def check_time_recorded(rec: Recorder, what: str, load_ns: float,
                        card: str, check_bp: int | None = None) -> dict:
    """Each recorded K1 and K2 call of a path held against its plain
    version on the same inputs (tolerance 0; ``plain_k1_grouped``,
    ``plain_k2_grouped``), then timed on the card (device ms per launch)
    beside its bound; returns per-kernel lists of (ms, bound ms,
    bound_by).  With ``check_bp`` only the K1 lanes and K2 reads of at
    most that many bases are held, timed and bounded (the plain
    versions last as long as their longest lane); each whole call's
    device time is logged beside."""
    times = {"sw_extend": [], "smem_machine": []}
    t0 = time.time()
    k1_whole = [k1_call_kwargs(r) for r in rec.k1]
    k1_sub = []
    for r, (a, kw) in zip(rec.k1, k1_whole):
        sub = _k1_lanes_upto(a, r[3], check_bp)
        if sub is not None:
            k1_sub.append(sub + (kw,))
    k1_plain = plain_k1_grouped([(a, kw) for a, _, kw in k1_sub])
    k2_whole = [k2_call_kwargs(r) for r in rec.k2]
    k2_sub = [sub for r, (_, kw) in zip(rec.k2, k2_whole)
              if (sub := _k2_reads_upto(kw, r[3], check_bp)) is not None]
    fm = k2_whole[0][0] if k2_whole else None
    k2_plain = plain_k2_grouped(fm, [kw for kw, _ in k2_sub]) \
        if k2_sub else []
    t_plain = time.time() - t0
    if check_bp is not None:
        whole1 = [round(device_ms(
            lambda: sw_cuda.extend_batch_banded_cuda(*a, **kw), 3), 4)
            for a, kw in k1_whole]
        whole2 = [round(device_ms(
            lambda: fm_cuda.smem_machine_cuda(fm, **kw), 3), 4)
            for _, kw in k2_whole]
        log(f"  whole calls' device ms: K1 {whole1}, K2 {whole2}; held, "
            f"timed and bounded below: the K1 lanes and K2 reads of <= "
            f"{check_bp} bp ({sum(len(a[1]) for a, _, _ in k1_sub)} of "
            f"{sum(len(a[1]) for a, _ in k1_whole)} K1 lanes, "
            f"{sum(len(kw['lens']) for kw, _ in k2_sub)} of "
            f"{sum(len(kw['lens']) for _, kw in k2_whole)} K2 reads) "
            f"[{card}]")
    for (args, got, kw), want in zip(k1_sub, k1_plain):
        err = max_abs_diff(got, want)
        if err:
            raise AssertionError(f"{what}: K1 differs from plain ({err})")
        ms = device_ms(lambda: sw_cuda.extend_batch_banded_cuda(*args, **kw),
                       3)
        bd = k1_bound_ms(args, kw["band"], want["rows"])
        times["sw_extend"].append((ms, *bd))
        log(f"  K1 M={args[0].shape[0]} Lq={args[0].shape[1]} "
            f"Lt={args[2].shape[1]} w={kw['band']}: {ms:.4f} ms device time,"
            f" longest lane {int(want['rows'].max())} rows = "
            f"{1e3 * ms / max(int(want['rows'].max()), 1):.3f} us a row; "
            f"bound {bd[0]:.4f} ms ({bd[1]}) [{card}]")
    for (kw, got), work in zip(k2_sub, k2_plain):
        keys = K2_KEYS_BASE + (K2_KEYS_P3 if kw.get("p3_seeds") else ())
        err = max_abs_diff(got, work, keys)
        if err:
            raise AssertionError(f"{what}: K2 differs from plain ({err})")
        ms = device_ms(lambda: fm_cuda.smem_machine_cuda(fm, **kw), 3)
        bd = k2_bound_ms(fm, kw, work)
        times["smem_machine"].append((ms, *bd))
        steps = int(work["steps"].max())
        dep_ms = 1e-6 * load_ns * int(work["rounds"].max())
        log(f"  K2 B={kw['reads'].shape[0]} L={kw['reads'].shape[1]} "
            f"S={kw['max_seeds']} cap={kw['step_cap']}: {ms:.4f} ms device "
            f"time, longest lane {steps} steps = "
            f"{1e3 * ms / max(steps, 1):.3f} us a step; bound {bd[0]:.4f} ms "
            f"({bd[1]}), dependent-load bound {dep_ms:.4f} ms [{card}]")
    log(f"{what}: K1 ({len(k1_sub)} of {len(rec.k1)} calls) and K2 "
        f"({len(k2_sub)} of {len(rec.k2)} calls) bit-equal to their plain "
        "versions on the path's own inputs"
        + (f", lanes of <= {check_bp} bp" if check_bp is not None else "")
        + f" (tolerance 0; plain versions {t_plain:.1f} s, grouped)")
    return times


def path_fields(launches: int, times=()) -> dict:
    """A kernel's numbers on one path: launches, and where the path's
    calls were timed, their mean device ms and bound."""
    out = dict(launches=launches)
    if times:
        out.update(ms=float(np.mean([t[0] for t in times])),
                   bound_ms=float(np.mean([t[1] for t in times])),
                   bound_by=max(t[1:] for t in times)[1])
    return out


def long_read_phase(aln, genome: str, card: str, load_ns: float):
    """128 simulated reads of 1.5-10 kb (about one indel per kb, 0.2%
    substitutions, 10% with a 200-400 bp random 3' tail, both strands)
    in batches of 32 through ``align_batch`` on the card, inside the
    Recorder and with the launch counters reset just before and read
    just after; every recorded K1/K2 call checked; the first 8 reads of
    <= 3 kb against the port's CPU run; placement >= 98%."""
    reads = simulate_long_reads(genome, LONG_READS, seed=17)
    bases = sum(len(s) for _, s in reads)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Recorder() as rec, StageTimer(StageTimer.LONG_TARGETS) as st:
        cuda_lib.reset_launches()
        t0 = time.time()
        recs = []
        for i in range(0, len(reads), LONG_BATCH):
            part = reads[i:i + LONG_BATCH]
            recs += aln.align_batch([s for _, s in part],
                                    [n for n, _ in part])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"long reads: {len(reads)} reads ({bases} bases, "
        f"{min(len(s) for _, s in reads)}-{max(len(s) for _, s in reads)} "
        f"bp) in batches of {LONG_BATCH} through align_batch: {wall:.2f} s "
        f"= {len(reads) / wall:.2f} reads/s, {bases / wall:.0f} bases/s; "
        f"peak device memory {peak:.0f} MiB; launches {launches} [{card}]")
    log("  stages (host clock, synchronised):")
    for k, v in st.ms.items():
        log(f"    {k:40s} {v:9.1f} ms x{st.calls[k]}")
    for k in cuda_lib.MAIN_PATH:
        if launches[k] <= 0:
            raise AssertionError(f"long reads: kernel {k} not launched")
    hdr = aln.index.header_from_index()
    ok, with_primary = placement_rate(
        "\n".join(r.to_sam(hdr) for rs in recs for r in rs))
    rate = ok / len(reads)
    log(f"long reads: {ok}/{len(reads)} ({100 * rate:.2f}%) place their "
        f"primary within 5 bp of the simulated start; {with_primary} have "
        "a primary")
    if rate < 0.98:
        raise AssertionError(f"long reads: placement {rate:.4f} < 0.98")
    times = check_time_recorded(rec, "long reads", load_ns, card,
                                check_bp=LONG_CHECK_BP)
    short = [i for i, (_, s) in enumerate(reads) if len(s) <= 3000][:8]
    t0 = time.time()
    cpu = BWAAligner(aln.index, device="cpu")
    want = cpu.align_batch([reads[i][1] for i in short],
                           [reads[i][0] for i in short])
    got = [recs[i] for i in short]
    sam_g = [r.to_sam(hdr) for rs in got for r in rs]
    if sam_g != [r.to_sam(hdr) for rs in want for r in rs]:
        raise AssertionError("long reads: GPU and CPU SAM differ")
    log(f"long reads: the first {len(short)} reads of <= 3 kb: GPU SAM == "
        f"CPU SAM byte for byte ({len(sam_g)} records; CPU run "
        f"{time.time() - t0:.1f} s)")
    return launches, times


def _mutate_period8(seq: str) -> str:
    swap = {"A": "C", "C": "G", "G": "T", "T": "A"}
    return "".join(swap[c] if k % 8 == 0 else c for k, c in enumerate(seq))


def paired_phase(aln, genome: str, card: str):
    """Two batches of 4096 pairs (2 x 150 bp, insert 400 +- 40) through
    ``align_pairs`` on the card, counters reset just before and read
    just after; mate 2 of 2% of the pairs mutated at period 8 (no 19 bp
    seed), so only rescue can place it.  The first 512 pairs against a
    CPU run given the card's insert-size statistics; >= 95% of the
    period-8 mates rescued within 20 bp of the truth, flagged proper."""
    from seqlib_tpu_torch.align.pairing import align_pairs
    n = PAIR_BATCH * PAIR_BATCHES
    r1, r2 = simulate_pairs([("sim_chr", genome)], n, read_len=READ_BP,
                            dist=400, stdev=40, seed=23)
    s1, s2 = [u.seq for u in r1], [u.seq for u in r2]
    names = [u.name for u in r1]
    rng = np.random.default_rng(29)
    mutated = np.flatnonzero(rng.random(n) < 0.02)
    truth = {}
    for i in mutated:
        # mate 2 is the fragment's start, or the reverse complement of its
        # end: whichever it is closer to
        beg, end = (int(x) for x in names[i].rsplit("_", 5)[1:3])
        fwd = genome[beg - 1:beg - 1 + READ_BP]
        rc = revcomp(genome[end - READ_BP:end])
        rev = sum(a != b for a, b in zip(s2[i], rc)) \
            < sum(a != b for a, b in zip(s2[i], fwd))
        truth[int(i)] = (end - READ_BP if rev else beg - 1, rev)
        s2[i] = _mutate_period8(s2[i])
    torch.cuda.synchronize()
    outs, stats = [], None
    with StageTimer(StageTimer.PAIR_TARGETS) as st:
        cuda_lib.reset_launches()
        t0 = time.time()
        for b in range(PAIR_BATCHES):
            sl = slice(b * PAIR_BATCH, (b + 1) * PAIR_BATCH)
            o1, o2, stats = align_pairs(aln, s1[sl], s2[sl], names[sl],
                                        stats=stats)
            outs.append((o1, o2, stats))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(cuda_lib.LAUNCHES)
    out1 = [r for o in outs for r in o[0]]
    out2 = [r for o in outs for r in o[1]]
    proper = sum(1 for a, b in zip(out1, out2)
                 if a and b and a[0].proper_pair() and b[0].proper_pair())
    fr = stats.dirs[1]
    log(f"pairs: {n} pairs in {PAIR_BATCHES} batches through align_pairs: "
        f"{wall:.2f} s = {n / wall:.0f} pairs/s; proper pairs "
        f"{proper}/{n} ({100 * proper / n:.2f}%); FR bounds [{fr.low}, "
        f"{fr.high}]; launches {launches}; rescue windows dropped "
        f"{aln.stats['rescue_windows_dropped']} [{card}]")
    log("  stages (host clock, synchronised):")
    for k, v in st.ms.items():
        log(f"    {k:40s} {v:9.1f} ms x{st.calls[k]}")
    for k in cuda_lib.MAIN_PATH:
        if launches[k] <= 0:
            raise AssertionError(f"pairs: kernel {k} not launched")
    ok = 0
    for i, (pos, rev) in truth.items():
        p = [r for r in out2[i] if not r.secondary_flag()]
        if p and abs(p[0].pos - pos) <= 20 and p[0].reverse_flag() == rev \
                and p[0].proper_pair() and p[0].flag & 0x80:
            ok += 1
    log(f"pairs: {ok}/{len(truth)} period-8 mates rescued within 20 bp of "
        f"the truth, flagged proper ({100 * ok / max(len(truth), 1):.2f}%)")
    if ok < 0.95 * len(truth):
        raise AssertionError("pairs: fewer than 95% of the period-8 mates "
                             "were rescued")
    k = PAIR_CHECK
    t0 = time.time()
    cpu = BWAAligner(aln.index, device="cpu")
    c1, c2, _ = align_pairs(cpu, s1[:k], s2[:k], names[:k], stats=outs[0][2])
    hdr = aln.index.header_from_index()
    g_sam = [r.to_sam(hdr) for rs in outs[0][0][:k] + outs[0][1][:k]
             for r in rs]
    if g_sam != [r.to_sam(hdr) for rs in c1 + c2 for r in rs]:
        raise AssertionError("pairs: GPU and CPU SAM differ")
    log(f"pairs: the first {k} pairs: GPU SAM == CPU SAM (given the card's "
        f"insert-size statistics) byte for byte ({len(g_sam)} records; CPU "
        f"run {time.time() - t0:.1f} s)")
    return launches, (s1, s2, names)


def bam_contigs(genome: str) -> list[tuple[str, str]]:
    """The main reference cut into chr1..chr3 (BAM_CUTS), the first
    BAM_NRUN bases of chr2 turned into N."""
    a, b = BAM_CUTS
    return [("chr1", genome[:a]),
            ("chr2", "N" * BAM_NRUN + genome[a + BAM_NRUN:b]),
            ("chr3", genome[b:])]


def decode_payload(payload: bytes) -> list:
    """Serialised BAM records -> BamRecords."""
    return list(iter(functools.partial(read_record, io.BytesIO(payload)),
                     None))


def region_set(hdr, n: int, seed: int) -> list[tuple[int, int, int]]:
    """n regions (tid, 1-based pos1, pos2) over every contig: around the
    N run at chr2's start, across each contig's ends, the rest random and
    up to 20 kb wide."""
    rng = np.random.default_rng(seed)
    out = [(1, 1, BAM_NRUN), (1, 1, BAM_NRUN + 200),
           (1, BAM_NRUN - 100, BAM_NRUN + 300),
           (1, BAM_NRUN - 50, BAM_NRUN + 20_000),
           (0, hdr.get_sequence_length(0) - 5_000,
            hdr.get_sequence_length(0)), (2, 1, 3_000)]
    while len(out) < n:
        tid = int(rng.integers(0, 3))
        ln = hdr.get_sequence_length(tid)
        p1 = int(rng.integers(1, ln))
        out.append((tid, p1, min(ln, p1 + int(rng.integers(0, 20_000)))))
    return out


def bam_phase(genome: str, reads, dev, card: str, workdir: str) -> dict:
    """The main reads to an indexed BAM on a three-contig reference, as a
    user of BAM output runs it, counters reset just before and read just
    after: ``align_stream_bam(sam=False)`` on the card ->
    ``BamWriter(BAM).write_records_bytes`` -> out.bam -> ``FastBamReader``
    -> the primaries' reads realigned on the card -> ``sort_by_position``
    -> ``BamWriter`` with ``enable_indexing`` -> out.sorted.bam + .bai ->
    region queries (``BamReader.set_region``, ``fetch_region``).  Then
    the checks: the first BAM_CHECK reads' BAM bytes on the card == on
    the CPU (as read and as realigned); out.bam decodes to the SAM lines
    of ``align_batch_bam(sam=True)``; FastBamReader == BamReader; >= 99%
    of the MAPQ >= 20 primaries keep contig and position on
    realignment; BAM_REGIONS regions equal each reader's brute-force
    answer, with the inline .bai and with one from ``build_index``."""
    t_phase = time.time()
    t0 = time.time()
    contigs = bam_contigs(genome)
    idx = FMIndex.construct(contigs)
    aln = BWAAligner(idx, device=dev)
    hdr = idx.header_from_index()
    log(f"bam: reference {[(n, len(s)) for n, s in contigs]} ({BAM_NRUN} N "
        f"at chr2's start); index + upload {time.time() - t0:.1f} s")
    out_bam = os.path.join(workdir, "out.bam")
    sorted_bam = os.path.join(workdir, "out.sorted.bam")
    stream = [UnalignedSequence(n, s) for n, s in reads]
    sync = torch.cuda.synchronize
    sync()
    cuda_lib.reset_launches()
    t0 = time.time()
    # -- the path ----------------------------------------------------------
    w = BamWriter(BAM)
    w.open(out_bam)
    w.set_header(hdr)
    w.write_header()
    t_write, payloads = 0.0, []
    for _, payload, _ in aln.align_stream_bam(iter(stream), batch_size=BATCH):
        t1 = time.time()
        w.write_records_bytes(payload)
        t_write += time.time() - t1
        payloads.append(payload)
    t1 = time.time()
    w.close()
    t_write += time.time() - t1
    t_align = time.time() - t0
    t1 = time.time()
    fr = FastBamReader(out_bam)
    fast_recs = list(fr)
    fr.close()
    t_fast = time.time() - t1
    prim = [r for r in fast_recs
            if not (r.flag & (FSECONDARY | FSUPPLEMENTARY | FUNMAP))]
    again = [UnalignedSequence(r.qname, r.seq, r.qualities()) for r in prim]
    t1 = time.time()
    payloads2 = [p for _, p, _ in aln.align_stream_bam(iter(again),
                                                       batch_size=BATCH)]
    sync()
    t_realign = time.time() - t1
    t1 = time.time()
    realigned = sort_by_position(
        [r for p in payloads2 for r in decode_payload(p)])
    w = BamWriter(BAM)
    w.open(sorted_bam)
    w.set_header(hdr)
    w.enable_indexing()
    for r in realigned:
        w.write_record(r)
    w.close()
    t_sorted = time.time() - t1
    regions = region_set(hdr, BAM_REGIONS, seed=37)
    rd = BamReader(sorted_bam)
    t1 = time.time()
    got_slow = []
    for tid, p1, p2 in regions:
        rd.set_region(GenomicRegion(tid, p1, p2))
        got_slow.append([r.to_sam(hdr) for r in iter(rd.next, None)])
    t_slow = time.time() - t1
    t1 = time.time()
    got_fast = []
    for tid, p1, p2 in regions:
        b = fetch_region(sorted_bam, tid, p1 - 1, p2)
        got_fast.append([] if b is None else
                        [b.record(i).to_sam(hdr) for i in range(len(b))])
    t_fetch = time.time() - t1
    rd.close()
    wall = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    # ------------------------------------------------------------------------
    raw = sum(len(p) for p in payloads)
    comp = os.path.getsize(out_bam)
    log(f"bam: the path in {wall:.2f} s: {len(reads)} reads aligned and "
        f"written in {t_align:.2f} s ({len(reads) / t_align:.0f} reads/s; "
        f"{raw} B of records, {comp} B of BAM); FastBamReader "
        f"{len(fast_recs)} records in {t_fast:.2f} s; {len(again)} "
        f"primaries realigned in {t_realign:.2f} s = "
        f"{len(again) / t_realign:.0f} reads/s; {len(realigned)} records "
        f"sorted and written with the index in {t_sorted:.2f} s; launches "
        f"{launches} [{card}]")
    for k in cuda_lib.MAIN_PATH:
        if launches[k] <= 0:
            raise AssertionError(f"bam: kernel {k} not launched")
    log(f"bam: BAM write inside the stream (write_records_bytes, sharing "
        f"the host with the stream's emission threads): "
        f"{raw / t_write / 1e6:.1f} MB/s of records [{card}]")
    # the two BGZF routes alone, in turns, on the path's payloads
    routes = {}
    for name in ("write_bulk", "write", "write", "write_bulk"):
        path = os.path.join(workdir, f"out.{name}.bgzf")
        t1 = time.time()
        w = BgzfWriter(path)
        for p in payloads:
            getattr(w, name)(p)
        w.close()
        routes.setdefault(name, []).append(
            (time.time() - t1, os.path.getsize(path)))
        if BgzfReader(path).read(raw + 1) != b"".join(payloads):
            raise AssertionError(f"bam: BgzfWriter.{name} does not inflate "
                                 "to the records")
    for name, what in (("write_bulk", "native deflate on threads"),
                       ("write", "Python zlib, one member at a time")):
        log(f"bam: BAM write, {name} ({what}), alone: " + ", ".join(
            f"{raw / t / 1e6:.1f} MB/s of records, {n / t / 1e6:.1f} MB/s "
            "of BGZF" for t, n in routes[name]) + f" [{card}]")
    bz = BgzfReader(out_bam)
    read_bam_header(bz)
    if bz.read(raw + 1) != b"".join(payloads):
        raise AssertionError("bam: out.bam does not inflate to the records")
    # -- checks ------------------------------------------------------------
    k = BAM_CHECK
    t1 = time.time()
    cpu = BWAAligner(idx, device="cpu")
    for what, batch in (("as read", stream[:k]), ("as realigned", again[:k])):
        seqs, names = [r.seq for r in batch], [r.name for r in batch]
        g = aln.align_batch_bam(seqs, names)
        c = cpu.align_batch_bam(seqs, names)
        if g[0] != c[0] or not np.array_equal(g[1], c[1]):
            raise AssertionError(f"bam: the first {k} reads {what}: GPU and "
                                 "CPU BAM bytes differ")
    log(f"bam: the first {k} reads, as read and as realigned: BAM bytes on "
        f"the card == on the CPU (CPU runs {time.time() - t1:.1f} s)")
    t1 = time.time()
    rd = BamReader(out_bam)
    slow_recs = list(iter(rd.next, None))
    t_read = time.time() - t1
    rd.close()
    slow_sam = [format_sam_line(r, hdr) for r in slow_recs]
    t1 = time.time()
    want = "".join(aln.align_batch_bam([r.seq for r in stream[i:i + BATCH]],
                                       [r.name for r in stream[i:i + BATCH]],
                                       sam=True)[0].decode()
                   for i in range(0, len(stream), BATCH)).splitlines()
    if slow_sam != want:
        bad = next(i for i, (a, b) in enumerate(zip(slow_sam, want))
                   if a != b) if len(slow_sam) == len(want) else -1
        raise AssertionError(f"bam: out.bam's SAM lines differ from "
                             f"align_batch_bam(sam=True) (record {bad}; "
                             f"{len(slow_sam)} vs {len(want)} lines)")
    if [format_sam_line(r, hdr) for r in fast_recs] != slow_sam:
        raise AssertionError("bam: FastBamReader and BamReader differ")
    log(f"bam: out.bam through BamReader == align_batch_bam(sam=True) line "
        f"for line ({len(want)} records; SAM run {time.time() - t1:.1f} s);"
        f" FastBamReader == BamReader")
    t1 = time.time()
    fr = FastBamReader(out_bam)
    n_cols = 0
    while (batch := fr.read_batch()) is not None:
        n_cols += len(batch)
    fr.close()
    t_cols = time.time() - t1
    log(f"bam: read out.bam: BamReader {len(slow_recs) / t_read:.0f} "
        f"records/s; FastBamReader {len(fast_recs) / t_fast:.0f} records/s "
        f"as BamRecords, {n_cols / t_cols:.0f} records/s in columnar batches"
        f" [{card}]")
    # realignment keeps contig and position
    first = {r.qname: (r.tid, r.pos, r.mapq) for r in prim}
    second = {r.qname: (r.tid, r.pos) for r in realigned
              if not (r.flag & (FSECONDARY | FSUPPLEMENTARY | FUNMAP))}
    conf = [q for q, v in first.items() if v[2] >= 20]
    kept = sum(1 for q in conf if second.get(q) == first[q][:2])
    log(f"bam: {kept}/{len(conf)} primaries with MAPQ >= 20 keep contig and "
        f"position on realignment ({100 * kept / max(len(conf), 1):.2f}%)")
    if kept < 0.99 * len(conf):
        raise AssertionError("bam: fewer than 99% of the confident "
                             "primaries keep their place on realignment")
    # regions against brute force, and the index built after close
    t1 = time.time()
    after = os.path.join(workdir, "out.after.bam")
    w = BamWriter(BAM)
    w.open(after)
    w.set_header(hdr)
    w.write_records_bytes(b"".join(encode_record(r) for r in realigned))
    w.close()
    if not w.build_index():
        raise AssertionError("bam: build_index failed")
    rd = BamReader(after)
    n_hits = n_across = 0
    keys = [(r.tid, r.pos) for r in realigned]
    # no record reaches further than `reach` past its pos, so the records
    # of a region start in [beg - reach, end)
    reach = max(max(r.position_end() - r.pos,
                    r.cigar.num_reference_consumed(), 1) for r in realigned)
    for (tid, p1, p2), slow, fast in zip(regions, got_slow, got_fast):
        beg, end = p1 - 1, p2
        on = realigned[bisect.bisect_left(keys, (tid, beg - reach)):
                       bisect.bisect_left(keys, (tid, end))]
        brute = [r.to_sam(hdr) for r in on if r.position_end() > beg]
        brute_fast = [r.to_sam(hdr) for r in on if r.pos + max(
            r.cigar.num_reference_consumed(), 1) > beg]
        rd.set_region(GenomicRegion(tid, p1, p2))
        again_after = [r.to_sam(hdr) for r in iter(rd.next, None)]
        if slow != brute or fast != brute_fast or again_after != slow:
            raise AssertionError(f"bam: region {hdr.id2name(tid)}:{p1}-{p2}"
                                 ": a reader differs from brute force")
        n_hits += len(slow)
        n_across += tid == 1 and p1 <= BAM_NRUN < p2
    rd.close()
    log(f"bam: {len(regions)} regions ({n_across} across chr2's N run; "
        f"{n_hits} records in all): BamReader and fetch_region == brute "
        f"force under each one's rule, the inline .bai == build_index's "
        f"(checks {time.time() - t1:.1f} s)")
    log(f"bam: region query {1e3 * t_slow / len(regions):.2f} ms through "
        f"BamReader.set_region, {1e3 * t_fetch / len(regions):.2f} ms "
        f"through fetch_region [{card}]")
    log(f"bam: K1 {launches['sw_extend']} and K2 {launches['smem_machine']}"
        f" launches on the path; phase {time.time() - t_phase:.1f} s "
        f"[{card}]")
    return launches, dict(aln=aln, payloads=payloads)


# ---------------------------------------------------------------------------
# the seqtools command line on bwa's index files
# ---------------------------------------------------------------------------

class LocateTimer:
    """Wraps the pipeline's SA locate: synchronised ms per call and the
    longest LF walk (steps) over the calls (a diagnostic run: it removes
    any overlap)."""

    def __init__(self):
        import seqlib_tpu_torch.align.device_pipeline as dp
        self._mod, self._orig = dp, dp.sa_lookup
        self.ms: list[float] = []
        self.longest = 0

    def __enter__(self):
        def timed(fm, ranks):
            torch.cuda.synchronize()
            t0 = time.time()
            pos, steps = self._orig(fm, ranks, return_steps=True)
            torch.cuda.synchronize()
            self.ms.append(1e3 * (time.time() - t0))
            self.longest = max(self.longest, int(steps.max()))
            return pos

        self._mod.sa_lookup = timed
        return self

    def __exit__(self, *exc):
        self._mod.sa_lookup = self._orig


def walk_bound_ms(entries: int, lanes: int, lane_steps: int, longest: int,
                  l2_bps: float, load_ns: float) -> tuple[float, str]:
    """Bound of one walk launch without steps, the largest of three:
    HBM, the ranks read and the positions written once (8 bytes each an
    entry) over 3.35 TB/s; L2, two 32-byte sectors a step (a block row
    spans two), one a lane's SA sample and the HBM stream (which passes
    through L2) over L2's measured read bandwidth; latency, the longest
    walk's steps x one dependent load."""
    hbm = 16 * entries
    times = {"HBM bytes": hbm / HBM_BYTES_PER_S,
             "L2 bytes": (64 * lane_steps + 32 * lanes + hbm) / l2_bps,
             "latency": 1e-9 * longest * load_ns}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def walk_phase(aln, genome: str, card: str, load_ns: float) -> dict:
    """The LF-walk kernel on the loaded index, on what the locate of one
    WALK_READS-read batch (the benchmark's batch) hands it: every
    recorded call's positions and the kernel's positions and steps
    again against the plain loop ``_sa_walk`` on the same ranks, on the
    card (tolerance 0); then the batch's call timed (device ms a launch
    over WALK_REPS, ms a call with the wrapper, the plain loop's
    synchronised ms) beside ``walk_bound_ms``, with L2's bandwidth
    measured on the index's rows and ``load_ns`` from K2's chase.
    Returns the kernel's fields of the ``kernels`` line."""
    t_phase = time.time()
    batch = simulate_reads(genome, WALK_READS, seed=13, length=READ_BP)
    with Recorder() as rec:
        aln.align_batch_bam([s for _, s in batch], [n for n, _ in batch])
        torch.cuda.synchronize()
    if not rec.walk:
        raise AssertionError("walk: no walk call on the loaded index")
    err = 0
    for fm, ranks, got in rec.walk:
        pos, steps = fm_cuda.sa_walk_cuda(fm, ranks, return_steps=True)
        want, wsteps = _sa_walk(fm, ranks, return_steps=True)
        err = max(err, int((got - want).abs().max()),
                  int((pos - want).abs().max()),
                  int((steps - wsteps).abs().max()))
    if err:
        raise AssertionError(f"walk: the kernel differs from the plain "
                             f"loop on the batch's ranks ({err})")
    fm, ranks, _ = max(rec.walk, key=lambda w: w[1].numel())
    _, steps = fm_cuda.sa_walk_cuda(fm, ranks, return_steps=True)
    valid = ranks >= 0
    lanes, lane_steps = int(valid.sum()), int(steps.sum())
    longest = int(steps.max())
    capped = int((steps == 64 * fm.sa_intv).sum())
    ms = device_ms(lambda: fm_cuda.sa_walk_cuda(fm, ranks), WALK_REPS)
    ev = cuda_ms(lambda: fm_cuda.sa_walk_cuda(fm, ranks), WALK_REPS)
    plain = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        _sa_walk(fm, ranks)
        torch.cuda.synchronize()
        plain.append(1e3 * (time.time() - t0))
    l2_bps = l2_bytes_per_s(fm.blocks)
    bound, by = walk_bound_ms(ranks.numel(), lanes, lane_steps, longest,
                              l2_bps, load_ns)
    log(f"walk: {len(rec.walk)} call(s) of one {WALK_READS}-read batch on "
        f"the loaded index (sa_intv {fm.sa_intv}): positions and steps == "
        f"the plain loop's (tolerance 0); {ranks.numel()} entries, {lanes} "
        f"lanes, {lane_steps} LF steps, the longest {longest}, {capped} "
        f"capped [{card}]")
    log(f"walk: {ms:.4f} ms device time a launch ({ev:.3f} ms/call with "
        f"the wrapper; plain loop {', '.join(f'{p:.0f}' for p in plain)} ms "
        f"on the card); bound {bound:.4f} ms ({by}: HBM "
        f"{1e3 * 16 * ranks.numel() / HBM_BYTES_PER_S:.4f} ms, L2 at "
        f"{l2_bps / 1e12:.2f} TB/s measured "
        f"{1e3 * (64 * lane_steps + 32 * lanes + 16 * ranks.numel()) / l2_bps:.4f}"
        f" ms, latency {longest} x {load_ns:.1f} ns = "
        f"{1e-6 * longest * load_ns:.4f} ms), {ms / bound:.2f}x; phase "
        f"{time.time() - t_phase:.1f} s [{card}]")
    return dict(
        name="sa_walk", route="cuda", source="seqlib_tpu_torch/csrc/sa_walk.cu",
        replaces="none (XLA walk: seqlib_tpu/ops/fm.py::sa_lookup)",
        max_abs_err=err, ms=ms, event_ms=ev, plain_ms=float(np.mean(plain)),
        bound_ms=bound, bound_by=by, library_ms=None, l2_bytes_per_s=l2_bps,
        lanes=lanes, lane_steps=lane_steps, longest=longest, capped=capped)


def write_fasta(path: str, contigs, width: int = 80) -> None:
    with open(path, "w") as fh:
        for name, seq in contigs:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + "\n")


def write_fastq(path: str, recs) -> None:
    """(name, seq) pairs as FASTQ, every quality 'I'."""
    with open(path, "w") as fh:
        for name, seq in recs:
            fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


def stream_sam(aln, stream) -> tuple[list, float, float]:
    """``align_stream_bam(sam=False)`` over the stream: (payloads, s,
    peak device MiB above what was allocated at its start)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    out = [p for _, p, _ in aln.align_stream_bam(iter(stream),
                                                 batch_size=BATCH)]
    torch.cuda.synchronize()
    return out, time.time() - t0, \
        (torch.cuda.max_memory_allocated() - base) / 2**20


def cli_phase(genome: str, reads, pairs, asm_contigs, bam_out: dict,
              card: str, workdir: str, load_ns: float) -> tuple[dict, dict]:
    """What a user of the command line runs, on the bam phase's
    three-contig reference written to ref.fa, counters reset just before
    and read just after: ``seqtools index ref.fa`` (bwa's five files) ->
    ``FMIndex.load`` (no full SA) -> ``align_stream_bam`` of the main
    reads on the loaded index (the LF-walk locate) -> ``seqtools align``
    of CLI_ALIGN reads to a BAM -> ``seqtools align -2`` of CLI_PAIRS of
    the paired phase's pairs -> ``seqtools fml -f`` of the
    assembly-local window's reads.  Then the checks: the loaded index's
    arrays equal the constructed one's; its stream's BAM records equal
    the bam phase's (constructed index) byte for byte; CLI_CHECK reads
    GPU == CPU on it; the CLI's BAM decodes to ``align_batch`` +
    ``mark_supplementary`` (``align`` restores no qualities); >= 98% of
    the pairs proper; fml's contig is the assembly-local phase's.  And
    loaded against constructed: reads/s in turns, the locate's ms a
    batch and longest walk, the SA tensor's bytes, peak memory.  Last,
    ``walk_phase`` on the loaded index.  Returns the path's launches and
    the walk kernel's fields."""
    from seqlib_tpu_torch import cli
    from seqlib_tpu_torch.align.pairing import mark_supplementary
    t_phase = time.time()
    built = bam_out["aln"]
    ref_fa = os.path.join(workdir, "ref.fa")
    write_fasta(ref_fa, bam_contigs(genome))
    fq = os.path.join(workdir, "reads.fq")
    write_fastq(fq, reads[:CLI_ALIGN])
    s1, s2, pnames = pairs
    p1, p2 = (os.path.join(workdir, f"pairs_{k}.fq") for k in (1, 2))
    write_fastq(p1, zip(pnames[:CLI_PAIRS], s1[:CLI_PAIRS]))
    write_fastq(p2, zip(pnames[:CLI_PAIRS], s2[:CLI_PAIRS]))
    w1, w2 = simulate_pairs([("win", genome[:ASM_WINDOW])], ASM_PAIRS,
                            read_len=READ_BP, error_rate=0.005, seed=7)
    win_fa = os.path.join(workdir, "window_reads.fa")
    with open(win_fa, "w") as fh:
        for i, u in enumerate(w1 + w2):
            fh.write(f">r{i}\n{u.seq}\n")
    out_bam = os.path.join(workdir, "cli.bam")
    pair_bam = os.path.join(workdir, "cli_pairs.bam")
    stream = [UnalignedSequence(n, s) for n, s in reads]
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.time()
    # -- the path ----------------------------------------------------------
    if cli.main(["index", ref_fa]) != 0:
        raise AssertionError("cli: seqtools index failed")
    t_index = time.time() - t0
    t1 = time.time()
    idx = FMIndex.load(ref_fa)
    t_load = time.time() - t1
    aln = BWAAligner(idx, device="cuda")
    loaded_payloads, t_loaded, peak_loaded = stream_sam(aln, stream)
    t1 = time.time()
    if cli.main(["align", "-F", fq, "-G", ref_fa, "-b", "-o", out_bam]) != 0:
        raise AssertionError("cli: seqtools align failed")
    torch.cuda.synchronize()
    t_cli = time.time() - t1
    t1 = time.time()
    if cli.main(["align", "-F", p1, "-2", p2, "-G", ref_fa, "-b", "-o",
                 pair_bam]) != 0:
        raise AssertionError("cli: seqtools align -2 failed")
    torch.cuda.synchronize()
    t_pairs = time.time() - t1
    t1 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["fml", "-f", "-F", win_fa])
    torch.cuda.synchronize()
    t_fml = time.time() - t1
    if rc != 0:
        raise AssertionError("cli: seqtools fml failed")
    wall = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    # ------------------------------------------------------------------------
    for k in PATH_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"cli: kernel {k} not launched")
    log(f"cli: the path in {wall:.2f} s: seqtools index {t_index:.2f} s "
        f"(FASTA read, build, write); FMIndex.load {t_load:.3f} s; "
        f"{len(stream)} reads on the loaded index {t_loaded:.2f} s = "
        f"{len(stream) / t_loaded:.0f} reads/s; seqtools align "
        f"{CLI_ALIGN} reads {t_cli:.2f} s = {CLI_ALIGN / t_cli:.0f} reads/s;"
        f" align -2 {CLI_PAIRS} pairs {t_pairs:.2f} s = "
        f"{CLI_PAIRS / t_pairs:.0f} pairs/s; fml -f {t_fml:.2f} s; "
        f"launches {launches} [{card}]")
    # -- checks ------------------------------------------------------------
    t1 = time.time()
    FMIndex.construct(bam_contigs(genome))
    t_build = time.time() - t1
    t1 = time.time()
    built.index.write(os.path.join(workdir, "again"))
    t_write = time.time() - t1
    for ext in (".pac", ".ann", ".amb", ".bwt", ".sa"):
        with open(ref_fa + ext, "rb") as a, \
                open(os.path.join(workdir, "again") + ext, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"cli: {ext} of seqtools index differs "
                                     "from the constructed index's")
    want = built.index
    if idx.sa_full is not None or idx.sa_intv != 32 \
            or idx.primary != want.primary \
            or not all(np.array_equal(getattr(idx, k), getattr(want, k))
                       for k in ("bwt_words", "cp_counts", "L2")) \
            or not np.array_equal(idx.sa_samples[1:],
                                  want.sa_full[::32][1:].astype(np.uint64)):
        raise AssertionError("cli: the loaded index differs from the "
                             "constructed one")
    log(f"cli: seqtools index's five files == FMIndex.write of the "
        f"constructed index; the loaded index's bwt_words, cp_counts, L2, "
        f"primary == the constructed index's, sa_samples[1:] == "
        f"sa_full[::32][1:]; no full SA. Host times: build "
        f"(FMIndex.construct) {t_build:.2f} s, write {t_write:.2f} s, "
        f"load {t_load:.3f} s [{card}]")
    if loaded_payloads != bam_out["payloads"]:
        raise AssertionError("cli: BAM records on the loaded index differ "
                             "from the constructed index's")
    n_rec = sum(len(decode_payload(p)) for p in loaded_payloads)
    log(f"cli: {len(stream)} reads on the loaded index: BAM records == the "
        f"bam phase's on the constructed index byte for byte ({n_rec} "
        f"records)")
    # loaded against constructed, in turns; then the locate alone
    runs = {"loaded": [(t_loaded, peak_loaded)], "constructed": []}
    for what, a in (("constructed", built), ("loaded", aln),
                    ("constructed", built)):
        _, t, peak = stream_sam(a, stream)
        runs[what].append((t, peak))
    for what, a in (("loaded", aln), ("constructed", built)):
        with LocateTimer() as lt:
            stream_sam(a, stream)
        sa = a.fm.sa
        resident = sum(t.numel() * t.element_size()
                       for t in (a.fm.blocks, a.fm.sa, a.text_t))
        log(f"cli: {what} index (sa_intv {a.fm.sa_intv}): "
            + ", ".join(f"{len(stream) / t:.0f}" for t, _ in runs[what])
            + f" reads/s (in turns); SA locate {np.mean(lt.ms):.2f} ms a "
            f"batch (synchronised, {len(lt.ms)} batches; the longest walk "
            f"{lt.longest} steps); SA on the card "
            f"{sa.numel() * sa.element_size()} B of {resident} B resident "
            f"(blocks, SA, text); the stream's peak device memory above "
            f"what was resident "
            + ", ".join(f"{p:.0f}" for _, p in runs[what])
            + f" MiB [{card}]")
    # GPU == CPU on the loaded index
    k = CLI_CHECK
    t1 = time.time()
    seqs, names = [s for _, s in reads[:k]], [n for n, _ in reads[:k]]
    g = aln.align_batch_bam(seqs, names, sam=True)
    c = BWAAligner(idx, device="cpu").align_batch_bam(seqs, names, sam=True)
    if g[0] != c[0] or not np.array_equal(g[1], c[1]):
        raise AssertionError("cli: loaded index, GPU and CPU SAM differ")
    log(f"cli: the first {k} reads on the loaded index: SAM on the card == "
        f"on the CPU byte for byte (CPU run {time.time() - t1:.1f} s)")
    # the CLI's BAM against the library
    hdr = idx.header_from_index()
    rd = BamReader(out_bam)
    got = [r.to_sam(hdr) for r in iter(rd.next, None)]
    rd.close()
    lib = []
    for i in range(0, CLI_ALIGN, 512):
        part = reads[i:min(i + 512, CLI_ALIGN)]
        for recs in aln.align_batch([s for _, s in part],
                                    [n for n, _ in part]):
            mark_supplementary(recs)
            lib += [r.to_sam(hdr) for r in recs]
    if got != lib:
        raise AssertionError(f"cli: seqtools align's BAM ({len(got)} "
                             f"records) differs from the library's "
                             f"({len(lib)})")
    log(f"cli: seqtools align's BAM == align_batch + mark_supplementary "
        f"line for line ({len(got)} records)")
    rd = BamReader(pair_bam)
    prim: dict = {}
    for r in iter(rd.next, None):
        if not r.flag & (FSECONDARY | FSUPPLEMENTARY):
            prim.setdefault(r.qname, []).append(r.proper_pair())
    rd.close()
    proper = sum(1 for v in prim.values() if len(v) == 2 and all(v))
    log(f"cli: seqtools align -2: {proper}/{CLI_PAIRS} pairs proper "
        f"({100 * proper / CLI_PAIRS:.2f}%)")
    if proper < 0.98 * CLI_PAIRS:
        raise AssertionError("cli: fewer than 98% of the pairs are proper")
    fml = [ln for ln in buf.getvalue().splitlines() if not
           ln.startswith(">")]
    if fml != asm_contigs:
        raise AssertionError(f"cli: seqtools fml gave {len(fml)} contig(s) "
                             f"of {[len(x) for x in fml]} bp, not the "
                             "assembly-local phase's")
    log(f"cli: seqtools fml -f == the assembly-local phase's contig "
        f"({len(fml[0])} bp)")
    log(f"cli: K1 {launches['sw_extend']}, K2 {launches['smem_machine']} "
        f"and walk {launches['sa_walk']} launches on the path; phase "
        f"{time.time() - t_phase:.1f} s [{card}]")
    return launches, walk_phase(aln, genome, card, load_ns)


# ---------------------------------------------------------------------------
# records: CRAM, intervals, filters, statistics and plots on the aligned reads
# ---------------------------------------------------------------------------

def record_key(r) -> tuple:
    """Every field a record carries, tags as a dict (CRAM stores a
    record's tags in sorted order)."""
    return (r.qname, r.flag, r.tid, r.pos, r.mapq, str(r.cigar), r.seq,
            None if r.qual is None else r.qual.tolist(), r.mtid, r.mpos,
            r.isize, dict(r.tags))


def write_cram(path: str, hdr, recs, reference=None) -> float:
    """``BamWriter(CRAM)`` (reference-based with ``reference``) and
    ``build_index``: seconds."""
    t0 = time.time()
    w = BamWriter(CRAM)
    if reference is not None:
        w.set_cram_reference(reference)
    if not w.open(path):
        raise AssertionError(f"records: cannot open {path}")
    w.set_header(hdr)
    w.write_header()
    for r in recs:
        w.write_record(r)
    w.close()
    if not w.build_index():
        raise AssertionError(f"records: build_index of {path} failed")
    return time.time() - t0


def read_all(path: str, reference=None) -> tuple[list, float]:
    t0 = time.time()
    rd = BamReader()
    if reference is not None:
        rd.set_cram_reference(reference)
    if not rd.open(path):
        raise AssertionError(f"records: cannot open {path}")
    recs = list(rd)
    rd.close()
    return recs, time.time() - t0


def query(path: str, regions, reference=None) -> tuple[list, float]:
    """Each region through ``BamReader.set_region``: its records' keys."""
    rd = BamReader()
    if reference is not None:
        rd.set_cram_reference(reference)
    rd.open(path)
    t0 = time.time()
    out = []
    for tid, p1, p2 in regions:
        if not rd.set_region(GenomicRegion(tid, p1, p2)):
            raise AssertionError(f"records: set_region failed on {path}")
        out.append([record_key(r) for r in rd])
    rd.close()
    return out, time.time() - t0


def bedgraph_track(text: str, pos1: int, size: int) -> np.ndarray:
    """A bedgraph's runs back to a dense track over [pos1, pos1 + size);
    the runs must be contiguous.  Its last position stays -1: the last
    run stops one short of the track's end (STCoverage's rule)."""
    v = np.full(size, -1, np.int64)
    at = pos1
    for line in text.splitlines():
        _, s, e, val = line.split("\t")
        s, e = int(s), int(e)
        if s != at:
            raise AssertionError(f"records: bedgraph gap at {at}")
        v[s - pos1:e - pos1] = int(val)
        at = e
    return v


def records_phase(card: str, workdir: str) -> dict:
    """What a user of this slice runs on the bam phase's sorted BAM
    (the main reads aligned on the card) and the cli phase's ref.fa and
    4,096-read FASTQ, counters reset just before and read just after:
    ``BamWriter(CRAM)`` with the reference attached (RR=1) and without,
    ``build_index`` -> ``BamReader`` over each; RECORDS_REGIONS of the
    bam phase's regions through the .crai; ``seqtools align -C`` on the
    card; the header tiled by ``GRC`` and every alignment's overlaps
    counted; a ``ReadFilterCollection`` JSON script (a BED region, MAPQ
    and clip ranges, a motif file, a subsample rate); ``STCoverage`` of
    chr1's first COV_WINDOW bases, ``BamStats``, one ``SeqPlot`` window.
    Checks: each CRAM decodes to the BAM's records field for field;
    each region equals the BAM's answer; the CLI's CRAM decodes to the
    cli phase's BAM; the overlap counts equal a brute-force count; each
    filter decision equals the rules' direct predicates; the coverage
    and its bedgraph equal a numpy difference-array coverage; the stats
    count every record; every read inside the plotted window is drawn
    once, and no other."""
    from seqlib_tpu_torch import cli
    from seqlib_tpu_torch.filters import (ReadFilterCollection, wang_hash,
                                          x31_hash)
    from seqlib_tpu_torch.intervals import GRC
    from seqlib_tpu_torch.plot import SeqPlot
    from seqlib_tpu_torch.stats import BamStats, STCoverage
    t_phase = time.time()
    sorted_bam = os.path.join(workdir, "out.sorted.bam")
    ref_fa = os.path.join(workdir, "ref.fa")
    fq = os.path.join(workdir, "reads.fq")
    rr1 = os.path.join(workdir, "out.rr1.cram")
    rr0 = os.path.join(workdir, "out.rr0.cram")
    cli_cram = os.path.join(workdir, "cli.cram")
    bam_recs, t_bam = read_all(sorted_bam)
    rd = BamReader(sorted_bam)
    hdr = rd.header()
    rd.close()
    n = len(bam_recs)
    # the filter's inputs: a BED of 20 regions, 8 k-mers of the reference
    rng = np.random.default_rng(53)
    bed = os.path.join(workdir, "filter.bed")
    bed_rows = []
    for _ in range(20):
        tid = int(rng.integers(0, hdr.num_sequences()))
        ln = hdr.get_sequence_length(tid)
        s = int(rng.integers(0, ln - 60_000))
        bed_rows.append((tid, s, s + int(rng.integers(1_000, 60_000))))
    with open(bed, "w") as fh:
        fh.write("# chrom start end\n")
        fh.writelines(f"{hdr.id2name(t)}\t{s}\t{e}\n" for t, s, e in bed_rows)
    chr1 = RefGenome(ref_fa).query_region(
        hdr.id2name(0), 0, min(hdr.get_sequence_length(0), 1_000_000) - 1)
    motifs = []
    while len(motifs) < 8:
        p = int(rng.integers(0, len(chr1) - 8))
        if "N" not in chr1[p:p + 8]:
            motifs.append(chr1[p:p + 8])
    motif_file = os.path.join(workdir, "motifs.txt")
    with open(motif_file, "w") as fh:
        fh.write("\n".join(motifs) + "\n")
    script = json.dumps({
        "bed": {"region": bed, "rules": [{"mapq": [20, 60],
                                          "subsample": 0.5},
                                         {"clip": [10, 1000]}]},
        "motif": {"region": "WG", "rules": [{"motif": motif_file}]}})
    regions = region_set(hdr, BAM_REGIONS, seed=37)[:RECORDS_REGIONS]
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.time()
    # -- the path ----------------------------------------------------------
    t_w1 = write_cram(rr1, hdr, bam_recs, reference=ref_fa)
    t_w0 = write_cram(rr0, hdr, bam_recs)
    got1, t_r1 = read_all(rr1, reference=ref_fa)
    got0, t_r0 = read_all(rr0)
    cram_regions, t_regions = query(rr1, regions, reference=ref_fa)
    t1 = time.time()
    if cli.main(["align", "-F", fq, "-G", ref_fa, "-C", "-o", cli_cram,
                 "--device", "cuda"]) != 0:
        raise AssertionError("records: seqtools align -C failed")
    torch.cuda.synchronize()
    t_cli = time.time() - t1
    t1 = time.time()
    tiles = GRC(width=10_000, ovlp=1_000, header=hdr)
    tiles.create_tree_map()
    q_tid = np.array([r.tid for r in bam_recs], np.int64)
    q1 = np.array([r.pos for r in bam_recs], np.int64)
    q2 = np.array([r.position_end() for r in bam_recs], np.int64)
    counts = tiles.count_overlaps_batch(q_tid, q1, q2)
    t_tiles = time.time() - t1
    t1 = time.time()
    rfc = ReadFilterCollection(script, hdr)
    kept = [rfc.is_valid(r) for r in bam_recs]
    t_filter = time.time() - t1
    t1 = time.time()
    cov = STCoverage(GenomicRegion(0, 0, COV_WINDOW - 1))
    fed = [r for r in bam_recs if r.tid == 0 and r.pos < COV_WINDOW]
    for r in fed:
        cov.add_read(r)
    graph = cov.to_bedgraph(hdr)
    stats = BamStats()
    for r in bam_recs:
        stats.add_read(r)
    table = repr(stats)
    t_stats = time.time() - t1
    t1 = time.time()
    starts = np.array([r.pos for r in fed])
    w0 = int(starts[len(starts) // 2])
    view = GenomicRegion(0, w0, w0 + PLOT_WINDOW)
    plot = SeqPlot()
    plot.set_view(view)
    drawn = plot.plot_alignment_records(bam_recs)
    t_plot = time.time() - t1
    wall = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    # ------------------------------------------------------------------------
    for k in cuda_lib.MAIN_PATH:
        if launches[k] <= 0:
            raise AssertionError(f"records: kernel {k} not launched")
    log(f"records: the path in {wall:.2f} s on {n} records of the sorted BAM "
        f"(read in {t_bam:.2f} s); launches {launches} [{card}]")
    # 1. CRAM of the aligned reads
    want = [record_key(r) for r in bam_recs]
    for what, got in (("RR=1", got1), ("reference-free", got0)):
        if [record_key(r) for r in got] != want:
            bad = next((i for i, (a, b) in enumerate(zip(got, bam_recs))
                        if record_key(a) != record_key(b)), -1)
            raise AssertionError(f"records: the {what} CRAM decodes to other "
                                 f"records than the BAM's (record {bad}; "
                                 f"{len(got)} vs {n})")
    size_bam = os.path.getsize(sorted_bam)
    log(f"records: CRAM RR=1 and reference-free decode through BamReader to "
        f"the sorted BAM's {n} records field for field (qname, flag, tid, "
        f"pos, mapq, CIGAR, seq, qual, mate fields, tags)")
    for what, path, tw, tr in (("RR=1", rr1, t_w1, t_r1),
                               ("reference-free", rr0, t_w0, t_r0)):
        size = os.path.getsize(path)
        log(f"records: CRAM {what}: write + .crai {tw:.2f} s = "
            f"{n / tw:.0f} records/s, read {tr:.2f} s = {n / tr:.0f} "
            f"records/s; {size / n:.1f} B a record against the BAM's "
            f"{size_bam / n:.1f} ({size} and {size_bam} B) [{card}]")
    # 2. region queries
    bam_regions, t_bam_regions = query(sorted_bam, regions)
    if cram_regions != bam_regions:
        bad = next(i for i, (a, b) in enumerate(zip(cram_regions,
                                                    bam_regions)) if a != b)
        raise AssertionError(f"records: region {regions[bad]} on the CRAM "
                             "differs from the BAM's answer")
    log(f"records: {len(regions)} of the bam phase's regions on the RR=1 CRAM"
        f" (.crai) == on the sorted BAM (.bai) ({sum(map(len, bam_regions))} "
        f"records); {1e3 * t_regions / len(regions):.1f} ms a query on the "
        f"CRAM, {1e3 * t_bam_regions / len(regions):.2f} on the BAM [{card}]")
    # 3. seqtools align -C
    cli_got, _ = read_all(cli_cram)
    cli_want, _ = read_all(os.path.join(workdir, "cli.bam"))
    if [record_key(r) for r in cli_got] != [record_key(r) for r in cli_want]:
        raise AssertionError("records: seqtools align -C's CRAM differs from "
                             "the cli phase's align -b BAM")
    log(f"records: seqtools align -C of {CLI_ALIGN} reads in {t_cli:.2f} s = "
        f"{CLI_ALIGN / t_cli:.0f} reads/s; its CRAM == the cli phase's BAM "
        f"record for record ({len(cli_got)} records, "
        f"{os.path.getsize(cli_cram)} B) [{card}]")
    # 4. intervals
    brute = np.zeros(n, np.int64)
    for c in range(hdr.num_sequences()):
        tt = [g for g in tiles if g.chr == c]
        s = np.array([g.pos1 for g in tt])[None, :]
        e = np.array([g.pos2 for g in tt])[None, :]
        m = q_tid == c
        brute[m] = ((s <= q2[m][:, None]) & (e >= q1[m][:, None])).sum(1)
    if not np.array_equal(counts, brute):
        raise AssertionError("records: count_overlaps_batch differs from "
                             "the brute-force count")
    log(f"records: GRC tiles of 10 kb (1 kb overlap): {len(tiles)}; the "
        f"overlaps of {n} alignments by count_overlaps_batch == brute force "
        f"(mean {counts.mean():.3f}, max {counts.max()}); tiling, tree and "
        f"counts {1e3 * t_tiles:.1f} ms [{card}]")
    # 5. filters, held against the rules' own predicates
    def in_bed(r):
        end = max(r.position_end(), r.pos)
        return any(t == r.tid and s <= end and e >= r.pos
                   for t, s, e in bed_rows)

    def sampled(r):
        h = wang_hash(x31_hash(r.qname) ^ 999)
        return (h & 0xFFFFFF) / 0x1000000 < 0.5

    n_rule = [0, 0, 0]
    for r, k in zip(bam_recs, kept):
        rules = (in_bed(r) and 20 <= r.mapq <= 60 and sampled(r),
                 in_bed(r) and 10 <= r.num_clip() <= 1000,
                 any(m in r.seq for m in motifs))
        if k != any(rules):
            raise AssertionError(f"records: the filter kept={k} {r.qname} "
                                 f"against its rules {rules}")
        for i, v in enumerate(rules):
            n_rule[i] += v
    n_kept = sum(kept)
    log(f"records: ReadFilterCollection (BED region + MAPQ 20-60 at "
        f"subsample 0.5, BED region + clip 10-1000, 8 motifs): kept {n_kept},"
        f" dropped {n - n_kept} (rules met {n_rule}), each decision == the "
        f"rules' predicates; {n / t_filter:.0f} records/s [{card}]")
    # 6. statistics and plot
    diff = np.zeros(COV_WINDOW + 1, np.int64)
    for r in fed:
        p, e = r.pos, r.position_end()
        if p >= 0 and e >= 0:
            diff[max(p, 0)] += 1
            diff[min(e + 1, COV_WINDOW)] -= 1
    track = np.cumsum(diff)[:COV_WINDOW]
    back = bedgraph_track(graph, 0, COV_WINDOW)
    if cov.max_cov() != track.max() \
            or not np.array_equal(back[:-1], track[:-1]) \
            or not np.array_equal(cov.v, track):
        raise AssertionError("records: STCoverage differs from the numpy "
                             "coverage")
    groups = list(stats.group_map.values())
    if sum(g.reads for g in groups) != n \
            or sum(g.mapq.total_count() for g in groups) != n \
            or len(table.splitlines()) != len(groups) + 1:
        raise AssertionError("records: BamStats does not count every record")
    inside = [r for r in bam_recs if r.tid == 0 and r.pos >= view.pos1
              and r.position_end() <= view.pos2]
    lines = drawn.splitlines()
    for r in bam_recs:
        if r.tid != 0 or r.position_end() <= view.pos1 or r.pos >= view.pos2:
            continue
        times = sum(ln.count(f"{r.qname}>>>1:{r.pos},") for ln in lines)
        want_times = sum(1 for x in inside if x.qname == r.qname
                         and x.pos == r.pos)
        if times != want_times:
            raise AssertionError(f"records: SeqPlot drew {r.qname} {times} "
                                 f"times, not {want_times}")
    if drawn.count(">>>") != len(inside) or not inside:
        raise AssertionError("records: SeqPlot drew other reads than the "
                             "window's")
    log(f"records: STCoverage of chr1:0-{COV_WINDOW} ({len(fed)} reads): "
        f"max_cov {cov.max_cov()}, {len(graph.splitlines())} bedgraph runs =="
        f" numpy coverage; BamStats {len(groups)} read group(s), {n} reads and"
        f" MAPQ counts; coverage and stats {t_stats:.2f} s; SeqPlot of "
        f"chr1:{view.pos1}-{view.pos2}: {len(inside)} reads inside on "
        f"{len(lines)} lines, each once, in {1e3 * t_plot:.1f} ms [{card}]")
    log(f"records: K1 {launches['sw_extend']} and K2 "
        f"{launches['smem_machine']} launches on the path (align -C); phase "
        f"{time.time() - t_phase:.1f} s [{card}]")
    return launches


def long_edge_phase(dev, fm, genome: str, card: str) -> None:
    """K1 and K2 at long shapes against their plain versions on the card
    (tolerance 0, grouped as in ``check_time_recorded``), each call
    timed: K1 across 4096 rows (the JAX package's packed tie-break), 48
    KB and 227 KB of shared memory for four lanes' codes; K2 past 48 KB
    (L 12,289) and past 227 KB (L 60,000, read from global memory), x0
    spread along the reads and a step cap of K2_EDGE_CAP."""
    k1_calls, k1_got = [], []
    for Lq, w, zdrop in K1_LONG_EDGES:
        args = k1_long_inputs(dev, 16, Lq, w, seed=Lq + w + zdrop)
        kw = dict(band=w, zdrop=zdrop)
        k1_calls.append((args, kw))
        k1_got.append(sw_cuda.extend_batch_banded_cuda(*args, **kw))
    t0 = time.time()
    k1_plain = plain_k1_grouped(k1_calls)
    log(f"K1 long edges: plain versions {time.time() - t0:.1f} s")
    for (args, kw), got, want in zip(k1_calls, k1_got, k1_plain):
        Lq, w, zdrop = args[0].shape[1], kw["band"], kw["zdrop"]
        err = max_abs_diff(got, want)
        if err:
            raise AssertionError(f"K1 long edge Lq={Lq} w={w} zdrop={zdrop}:"
                                 f" kernel differs from plain ({err})")
        smem_kb = 4 * (2 * ((Lq + 15) // 16 * 16) + w + 16) / 1024
        ms = device_ms(lambda: sw_cuda.extend_batch_banded_cuda(*args, **kw),
                       3)
        bd = k1_bound_ms(args, w, want["rows"])
        log(f"K1 long edge M=16 Lq={Lq} w={w} zdrop={zdrop} (four lanes' "
            f"codes ~{smem_kb:.0f} KB): bit-equal (tolerance 0); {ms:.4f} ms "
            f"device time, {1e3 * ms / max(int(want['rows'].max()), 1):.3f} "
            f"us a row; bound {bd[0]:.4f} ms ({bd[1]}) [{card}]")
    k2_calls = []
    for L in K2_LONG_EDGES:
        B = 64
        reads, lens, active = edge_read_batch(genome, B, L, seed=L)
        kw = dict(reads=reads, lens=lens,
                  x0=np.linspace(0, L - 1, B).astype(np.int32),
                  min_intv=np.ones(B, np.int32), active=active)
        kw = {k: torch.from_numpy(np.asarray(v)).to(dev)
              for k, v in kw.items()}
        kw.update(max_seeds=256, min_seed_len=19, C=8, max_rounds=L,
                  step_cap=K2_EDGE_CAP, p3_seeds=8, p3_max_intv=20)
        k2_calls.append(kw)
    k2_got = [fm_cuda.smem_machine_cuda(fm, **kw) for kw in k2_calls]
    t0 = time.time()
    k2_plain = plain_k2_grouped(fm, k2_calls)
    log(f"K2 long edges: plain versions {time.time() - t0:.1f} s")
    for kw, got, want in zip(k2_calls, k2_got, k2_plain):
        B, L = kw["reads"].shape
        err = max_abs_diff(got, want, K2_KEYS_BASE + K2_KEYS_P3)
        if err:
            raise AssertionError(f"K2 long edge L={L}: kernel differs from "
                                 f"plain ({err})")
        ms = device_ms(lambda: fm_cuda.smem_machine_cuda(fm, **kw), 3)
        steps = int(want["steps"].max())
        log(f"K2 long edge B={B} L={L} (four reads ~{4 * L / 1024:.0f} KB), "
            f"cap {K2_EDGE_CAP}: bit-equal (tolerance 0; "
            f"{int(want['n_dropped'].sum())}"
            f" lanes at the cap); {ms:.4f} ms device time, "
            f"{1e3 * ms / max(steps, 1):.3f} us a step [{card}]")


# ---------------------------------------------------------------------------
# BFC error correction and string-graph assembly
# ---------------------------------------------------------------------------

class WalkRecorder:
    """Keeps the inputs and outputs of each spectrum walk BFC runs (by
    reference: the walk changes none of its inputs)."""

    def __init__(self):
        self.calls: list = []
        self._orig = None

    def __enter__(self):
        import seqlib_tpu_torch.assembly.bfc as bfc_mod
        self._mod, self._orig = bfc_mod, bfc_mod.correct_reads_device

        def walk(*a):
            out = self._orig(*a)
            self.calls.append((a, out))
            return out

        bfc_mod.correct_reads_device = walk
        return self

    def __exit__(self, *exc):
        self._mod.correct_reads_device = self._orig


def run_assembly(reads: list[str], dev):
    """BFC train and error_correct, then FermiAssembler.perform_assembly
    on the corrected reads, on ``dev``; returns (bfc, assembler)."""
    b = BFC(device=dev)
    for s in reads:
        b.add_sequence(s)
    b.train()
    b.error_correct()
    f = FermiAssembler(device=dev)
    f.add_reads([UnalignedSequence(f"r{i}", s)
                 for i, s in enumerate(b.m_seqs)])
    f.perform_assembly()
    return b, f


def _gfa(f) -> str:
    buf = io.StringIO()
    f.write_gfa(buf)
    return buf.getvalue()


def log_stages(st: StageTimer) -> None:
    log("  stages (host clock, synchronised):")
    for k, v in st.ms.items():
        log(f"    {k:42s} {v:9.1f} ms x{st.calls[k]}")


def walk_trace(rec: WalkRecorder, what: str, card: str):
    """The last recorded walk again under torch.profiler: its launches
    and the device's busy share."""
    args, _ = rec.calls[-1]
    res = traced(lambda: kmer.correct_reads_device(*args), what, card, top=6)
    B, L = args[0].shape
    if res:
        log(f"{what}: {res[0]} device events for B = {B} reads of up to "
            f"{L} columns, device busy {100 * res[1]:.1f}% [{card}]")
    return res


def assembly_local_phase(genome: str, card: str) -> dict:
    """Configuration 3: 5,000 pairs of 2 x 150 bp (error rate 0.005, seed
    7) over genome[0:50 kb] through BFC and FermiAssembler on the card,
    counters reset just before and read just after: exactly one contig,
    >= 99% of the window, an exact substring of it or of its reverse
    complement; corrected reads, contigs, unitig links and GFA text
    equal to the port's CPU run."""
    window = genome[:ASM_WINDOW]
    r1, r2 = simulate_pairs([("win", window)], ASM_PAIRS, read_len=READ_BP,
                            error_rate=0.005, seed=7)
    reads = [u.seq for u in r1 + r2]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with StageTimer(StageTimer.ASM_TARGETS) as st, WalkRecorder() as wr:
        cuda_lib.reset_launches()
        t0 = time.time()
        b, f = run_assembly(reads, "cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    ctgs = f.get_contigs()
    log(f"assembly-local: {len(reads)} reads over a {ASM_WINDOW} bp window: "
        f"BFC (k {b.kmer}, kcov {b.kcov:.3f}, min_cov {b.min_cov}, "
        f"{b.table.keys.size} unique k-mers, {len(wr.calls[0][0][0])} reads "
        f"walked) and assembly in {wall:.2f} s; {len(ctgs)} contig(s) of "
        f"{[len(c) for c in ctgs]} bp; peak device memory {peak:.0f} MiB; "
        f"launches {launches} [{card}]")
    log_stages(st)
    graph = st.ms["assembly in all"] - st.ms["assembly: k-mer read filter"] \
        - st.ms["assembly: overlaps (host numpy)"]
    log(f"    {'assembly: graph, unitigs (host numpy)':42s} {graph:9.1f} ms")
    if len(ctgs) != 1 or len(ctgs[0]) < 0.99 * len(window) \
            or not (ctgs[0] in window or revcomp(ctgs[0]) in window):
        raise AssertionError("assembly-local: not one exact contig over "
                             ">= 99% of the window")
    t0 = time.time()
    bc, fc = run_assembly(reads, "cpu")
    links = [u.links for u in f.get_unitigs()]
    if bc.m_seqs != b.m_seqs or fc.get_contigs() != ctgs \
            or [u.links for u in fc.get_unitigs()] != links \
            or _gfa(fc) != _gfa(f):
        raise AssertionError("assembly-local: GPU and CPU runs differ")
    log(f"assembly-local: corrected reads, contigs, unitig links and GFA "
        f"text == the CPU run's byte for byte (CPU run "
        f"{time.time() - t0:.1f} s)")
    walk_trace(wr, "assembly-local: one traced walk", card)
    return launches, ctgs


def pair_truths(names: list[str], genome: str) -> list[tuple[str, str]]:
    """Each read's error-free truth, from the fragment named in
    ``simulate_pairs``'s read name: its start, or the reverse complement
    of its end (a read is one of the two)."""
    out = []
    for nm in names:
        beg, end = (int(x) for x in nm.rsplit("_", 5)[1:3])
        out.append((genome[beg - 1:beg - 1 + READ_BP],
                    revcomp(genome[end - READ_BP:end])))
    return out


def truth_matches(truths, seqs: list[str]) -> int:
    return sum(s == a or s == b for (a, b), s in zip(truths, seqs))


def bfc_genome_phase(genome: str, card: str) -> dict:
    """BFC on the whole reference at 30x (2 x 150 bp pairs, error rate
    0.005) on the card, counters reset just before and read just after:
    the card's table equals the port's CPU count, a sample of walked
    rows equals a CPU walk with the card's table, and the corrected
    reads reach the bar of tests/test_assembly.py against their truth."""
    t0 = time.time()
    r1, r2 = simulate_pairs([("sim_chr", genome)], BFC_PAIRS,
                            read_len=READ_BP, dist=400, stdev=40,
                            error_rate=0.005, seed=31)
    reads = [u.seq for u in r1 + r2]
    names = [u.name for u in r1 + r2]
    del r1, r2
    n = len(reads)
    log(f"bfc-genome: {n} reads ({n * READ_BP} bases) simulated in "
        f"{time.time() - t0:.1f} s")
    b = BFC(device="cuda")
    for s in reads:
        b.add_sequence(s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with StageTimer(StageTimer.BFC_TARGETS) as st, WalkRecorder() as wr:
        cuda_lib.reset_launches()
        t0 = time.time()
        b.train()
        b.error_correct()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    (wargs, (wcodes, wnchg)), = wr.calls
    log(f"bfc-genome: train + error_correct {wall:.2f} s = {n / wall:.0f} "
        f"corrected reads/s, {n * READ_BP / wall:.0f} bases/s; k "
        f"{b.kmer}, {b.table.keys.size} unique k-mers, kcov {b.kcov:.4f}, "
        f"min_cov {b.min_cov}; {wargs[0].shape[0]} reads walked, "
        f"{int((wnchg > 0).sum())} changed; peak device memory {peak:.0f} "
        f"MiB; launches {launches} [{card}]")
    log_stages(st)
    # the card's table against the port's CPU count on the same reads
    t0 = time.time()
    reads_np, lens_np = encode_reads(reads)
    keys_c, cnt_c = kmer.count_kmers_device(*kmer.canonical_kmers_device(
        torch.from_numpy(reads_np), torch.from_numpy(lens_np), b.kmer))
    keys_g, cnt_g = (x.cpu() for x in b._dev)
    if not (torch.equal(keys_g, keys_c) and torch.equal(cnt_g, cnt_c)):
        raise AssertionError("bfc-genome: the card's table differs from the "
                             "CPU count")
    log(f"bfc-genome: the card's table == the CPU count ({keys_c.numel()} "
        f"keys, {int(cnt_c.sum())} k-mers; CPU {time.time() - t0:.1f} s)")
    del keys_c, cnt_c
    # a sample of walked rows, walked on the CPU with the card's table
    t0 = time.time()
    rows = torch.from_numpy(np.sort(np.random.default_rng(5).choice(
        wargs[0].shape[0], min(BFC_SAMPLE, wargs[0].shape[0]),
        replace=False))).to(wargs[0].device)
    sl = wargs[1][rows]
    L = int(sl.max())
    cc, cn = kmer.correct_reads_device(wargs[0][rows, :L].cpu(), sl.cpu(),
                                       keys_g, cnt_g, *wargs[4:])
    if not (torch.equal(cc, wcodes[rows, :L].cpu())
            and torch.equal(cn, wnchg[rows].cpu())):
        raise AssertionError("bfc-genome: walked rows differ from a CPU "
                             "walk with the card's table")
    log(f"bfc-genome: {rows.numel()} walked rows == a CPU walk with the "
        f"card's table ({int((cn > 0).sum())} of them changed; CPU "
        f"{time.time() - t0:.1f} s)")
    # against the truth in the read names
    t0 = time.time()
    truths = pair_truths(names, genome)
    before = truth_matches(truths, reads)
    after = truth_matches(truths, b.m_seqs)
    log(f"bfc-genome: reads equal to their truth {before} -> {after} of {n}"
        f" ({100 * before / n:.2f}% -> {100 * after / n:.2f}%; check "
        f"{time.time() - t0:.1f} s)")
    if after < before + 0.5 * (n - before) or after < 0.9 * n:
        raise AssertionError("bfc-genome: correction below the bar")
    walk_trace(wr, "bfc-genome: one traced walk", card)
    return launches


# ---------------------------------------------------------------------------
# wide: int64 ranks and positions (K2's int64 instantiation), sharded
# ---------------------------------------------------------------------------

def sharded_vs_single(got: list[str], want: list[str]) -> tuple[int, int]:
    """SAM lines of a sharded index against a single index's, read by
    read (both in read order): (reads equal, reads whose primary moved).
    A read is equal when its records agree in the fields the JAX
    package's sharded test holds (name, flag, place, MAPQ, CIGAR, SEQ,
    NM, AS); otherwise its alignments (place, strand, CIGAR, NM, AS)
    must be the same and the two primaries of equal AS: the sharded
    index walks regions by global keys, which order equal-score hits
    differently, and bwa's tie-break picks by that order.  Anything else
    raises."""

    def reads(lines):
        out: dict[str, list] = {}
        for ln in lines:
            f = ln.split("\t")
            tags = {t[:2]: t for t in f[11:]}
            out.setdefault(f[0], []).append(
                (f[1], f[2], f[3], f[4], f[5], f[9], tags.get("NM"),
                 tags.get("AS")))
        return out

    def hits(recs):
        return sorted((r[1], r[2], int(r[0]) & 16, r[4], r[6], r[7])
                      for r in recs)

    def primary_as(recs):
        return [r[7] for r in recs if not int(r[0]) & 0x900]

    g, w = reads(got), reads(want)
    if list(g) != list(w):
        raise AssertionError("sharded: other reads than the single index's")
    same = flips = 0
    for name, wr in w.items():
        gr = g[name]
        if sorted(gr) == sorted(wr):
            same += 1
        elif hits(gr) == hits(wr) and primary_as(gr) == primary_as(wr):
            flips += 1
        else:
            raise AssertionError(f"sharded: {name} differs from the single "
                                 f"index's: {gr} against {wr}")
    return same, flips


def synthetic_wide_index(n_bp: int, shares, seed: int, dev) -> DeviceFMIndex:
    """A wide DeviceFMIndex over a synthetic BWT of ``n_bp`` bases (a
    multiple of 128) drawn i.i.d. with the four codes' ``shares``, built
    on the card: the words from a seeded generator, each block's
    checkpoints from the words' cumulative counts (SWAR popcount), L2
    from the totals, the primary at n_bp // 3.  It has no text and no SA
    (only the SMEM machine runs on it)."""
    nb = n_bp // 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cut = torch.tensor(np.cumsum(shares)[:3], dtype=torch.float32,
                       device=dev)
    words = torch.zeros(nb * 8, dtype=torch.int64, device=dev)
    for j in range(16):
        u = torch.rand(nb * 8, generator=gen, device=dev)
        words |= torch.bucketize(u, cut, right=True).to(torch.int64) \
            << (2 * (15 - j))
        del u
    cp = torch.zeros((nb + 1, 4), dtype=torch.int64, device=dev)
    for c in range(4):
        nx = ~(words ^ (c * 0x55555555)) & 0xFFFFFFFF
        per = fm_ops.popcount32(nx & (nx >> 1) & 0x55555555)
        cp[1:, c] = per.view(nb, 8).sum(dim=1).cumsum(0)
        del nx, per
    pairs = words.view(nb, 4, 2)
    rows = torch.zeros((nb + 1, 4), dtype=torch.int64, device=dev)
    rows[:nb] = pairs[..., 0] | (pairs[..., 1] << 32)
    del words, pairs
    blocks = torch.cat([cp, rows], dim=1).contiguous()
    del rows
    tot = [int(v) for v in cp[nb]]
    L2 = [0, tot[0], tot[0] + tot[1], tot[0] + tot[1] + tot[2], n_bp]
    return DeviceFMIndex(
        blocks=blocks, sa=torch.zeros(1, dtype=torch.int64, device=dev),
        L2=torch.tensor(L2, dtype=torch.int64, device=dev),
        L2_host=tuple(L2), primary=n_bp // 3, seq_len=n_bp,
        l_pac=n_bp // 2)


def synthetic_k2_check(fm, shares, min_seed_len: int, seed: int, dev,
                       what: str, card: str) -> None:
    """K2 (int64 instantiation) against its plain version on ``fm`` for
    WIDE_SYNTH_READS seeded 150 bp reads drawn with ``shares``: the
    collect call (pass 3 fused) and a re-seed call from each read's
    middle, bit-equal, with interval starts past 2^31 among the collect
    call's seeds; each call timed beside its bound."""
    rng = np.random.default_rng(seed)
    B, L = WIDE_SYNTH_READS, READ_BP
    reads = torch.from_numpy(rng.choice(4, size=(B, L), p=shares)
                             .astype(np.uint8)).to(dev)
    lens = torch.full((B,), L, dtype=torch.int32, device=dev)
    calls = [dict(reads=reads, lens=lens,
                  x0=torch.zeros(B, dtype=torch.int32, device=dev),
                  min_intv=torch.ones(B, dtype=torch.int32, device=dev),
                  active=lens > 0, max_seeds=16, min_seed_len=min_seed_len,
                  C=8, max_rounds=L, step_cap=4 * L + 16, p3_seeds=8,
                  p3_max_intv=20),
             dict(reads=reads, lens=lens,
                  x0=torch.full((B,), L // 2, dtype=torch.int32, device=dev),
                  min_intv=torch.full((B,), 2, dtype=torch.int32,
                                      device=dev),
                  active=lens > 0, max_seeds=4, min_seed_len=min_seed_len,
                  C=8, max_rounds=1, step_cap=2 * L + 8)]
    for kw in calls:
        keys = K2_KEYS_BASE + (K2_KEYS_P3 if kw.get("p3_seeds") else ())
        got = fm_cuda.smem_machine_cuda(fm, **kw)
        work = _smem_machine(fm, **kw, count_work=True)
        err = max_abs_diff(got, work, keys)
        n = got["n_seeds"].to(torch.int64)
        live = torch.arange(kw["max_seeds"], device=dev)[None, :] < n[:, None]
        il = got["intv_l"][live]
        past = int((il >= 2**31).sum())
        if err or got["intv_l"].dtype != torch.int64:
            raise AssertionError(f"{what}: K2 wide differs from plain "
                                 f"({err})")
        ms = device_ms(lambda: fm_cuda.smem_machine_cuda(fm, **kw), 3)
        bd = k2_bound_ms(fm, kw, work)
        log(f"  {what} B={B} S={kw['max_seeds']} p3={kw.get('p3_seeds', 0)}"
            f" rounds={kw['max_rounds']}: K2 wide == plain (tolerance 0; "
            f"{int(n.sum())} seeds, {past} with an interval start past 2^31,"
            f" largest {int(il.max()) if il.numel() else 0}); {ms:.4f} ms "
            f"device time, bound {bd[0]:.4f} ms ({bd[1]}) [{card}]")
        if kw.get("p3_seeds") and past == 0:
            raise AssertionError(f"{what}: no interval start past 2^31")


def biased_rank_check(idx, dev, card: str) -> None:
    """The biased-checkpoint index on the main reference (rank'(c, k) =
    rank(c, k) + WIDE_BIAS[c]): the plain rank, rank4 and FMD
    bi-extension on the card against the host index's int64 ranks plus
    the bias, values past 2^31.  K2 cannot run on it: a biased
    interval points past the BWT."""
    bias = np.array(WIDE_BIAS, np.int64)
    fm = DeviceFMIndex.from_host(idx, device=dev, wide=True,
                                 count_bias=bias)
    rng = np.random.default_rng(5)
    n = idx.seq_len
    k = np.concatenate([rng.integers(0, n + 1, 100_000),
                        [0, 1, 127, 128, n - 1, n]]).astype(np.int64)
    kt = torch.from_numpy(k).to(dev)
    host = np.stack([idx.rank(c, k).astype(np.int64) for c in range(4)], 1)
    want = host + bias[None, :]
    got4 = fm_ops.rank4(fm, kt).cpu().numpy()
    got = np.stack([fm_ops.rank(fm, c, kt).cpu().numpy() for c in range(4)],
                   1)
    if not (np.array_equal(got4, want) and np.array_equal(got, want)):
        raise AssertionError("biased ranks differ from host int64 + bias")
    s = np.minimum(rng.integers(0, 5000, k.size), n + 1 - k)
    k4, l4, s4 = fm_ops.bi_extend_back(
        fm, kt, kt, torch.from_numpy(s).to(dev))
    plain = DeviceFMIndex.from_host(idx, device=dev, wide=True)
    k4p, l4p, s4p = fm_ops.bi_extend_back(
        plain, kt, kt, torch.from_numpy(s).to(dev))
    if not (torch.equal(k4 - k4p, torch.tensor(bias, device=dev)
                        .expand_as(k4))
            and torch.equal(s4, s4p) and torch.equal(l4, l4p)):
        raise AssertionError("biased bi-extension differs")
    log(f"wide: biased-checkpoint index on the main reference: rank, rank4 "
        f"and bi-extension of {k.size} positions on the card == host int64 "
        f"+ bias ({int((want >= 2**31).sum())} of {want.size} ranks past "
        f"2^31, largest {int(want.max())}) [{card}]")


HG38_2L = 6_200_000_000           # an hg38-scale 2L text, for the reckoning


def wide_device_bytes(two_l: int) -> dict:
    """Device bytes of a wide index over a 2L text of ``two_l`` bases,
    as ``DeviceFMIndex.from_host`` and ``BWAAligner`` lay them out: the
    uint8 text, the BWT words (inside the rows), the 64-byte checkpoint
    rows, the int64 SA sampled every 32 ranks and the full int64 SA."""
    rows = -(-two_l // 128) + 1
    return dict(text=two_l, bwt_words=(two_l + 15) // 16 * 4,
                rows=rows * 64, sa_sampled=(two_l // 32 + 1) * 8,
                sa_full=(two_l + 1) * 8)


def wide_phase(genome: str, idx, reads, outs, narrow: dict, dev,
               card: str) -> dict:
    """What a user with a reference past ~1.07 Gbp runs, shown three
    ways (an index past 2^31 cannot be built in this script's time):
    K2's int64 instantiation on synthetic BWTs past 2^31 and the biased
    ranks; the main path with ``wide=True`` on the main reference
    (records == the narrow path's); a sharded index through ``seqtools
    align`` (records == the single index's).  Returns per-kernel
    {"wide": path fields, "sharded": path fields}."""
    from seqlib_tpu_torch import cli
    from seqlib_tpu_torch.align.pairing import mark_supplementary
    from seqlib_tpu_torch.index import ShardedFMIndex
    t_phase = time.time()
    b = wide_device_bytes(HG38_2L)
    log(f"wide: device bytes of an index over a 2L text of {HG38_2L} "
        f"(hg38 scale): text {b['text'] / 1e9:.2f} GB, BWT words "
        f"{b['bwt_words'] / 1e9:.2f} GB inside the 64-byte rows "
        f"{b['rows'] / 1e9:.2f} GB, SA sampled at 32 "
        f"{b['sa_sampled'] / 1e9:.2f} GB, full SA {b['sa_full'] / 1e9:.2f} "
        f"GB: text + rows + full SA {(b['text'] + b['rows'] + b['sa_full']) / 1e9:.2f}"
        f" GB, with the sampled SA "
        f"{(b['text'] + b['rows'] + b['sa_sampled']) / 1e9:.2f} GB, of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.1f} GB")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    fm = synthetic_wide_index(WIDE_SYNTH_BP, (0.25,) * 4, 31, dev)
    torch.cuda.synchronize()
    log(f"wide: synthetic BWT of {WIDE_SYNTH_BP} bases ({fm.blocks.shape[0]}"
        f" 64-byte rows, {fm.blocks.numel() * 8 / 2**30:.2f} GiB, L2 "
        f"{list(fm.L2_host)}) built on the card in {time.time() - t0:.1f} s;"
        f" peak {(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB"
        f" above the run's [{card}]")
    synthetic_k2_check(fm, (0.25,) * 4, 12, 32, dev,
                       "uniform synthetic BWT", card)
    del fm
    fm = synthetic_wide_index(WIDE_SYNTH_BP, WIDE_SKEW, 33, dev)
    if fm.L2_host[4] - fm.L2_host[3] < 2**31:
        raise AssertionError("skewed synthetic BWT: T count under 2^31")
    log(f"wide: skewed synthetic BWT (shares {WIDE_SKEW}): {fm.L2_host[4] - fm.L2_host[3]}"
        f" T, the last rows' T checkpoints past 2^31")
    synthetic_k2_check(fm, (0.05, 0.05, 0.05, 0.85), 8, 34, dev,
                       "skewed synthetic BWT", card)
    del fm
    torch.cuda.empty_cache()
    biased_rank_check(idx, dev, card)

    # ---- the main path, wide=True ----------------------------------------
    t0 = time.time()
    aln_w = BWAAligner(idx, wide=True, device=dev)
    log(f"wide: BWAAligner(wide=True) on the main reference: blocks "
        f"{tuple(aln_w.fm.blocks.shape)} {aln_w.fm.blocks.dtype} "
        f"({aln_w.fm.blocks.numel() * 8 / 2**20:.1f} MiB against "
        f"{narrow['blocks_mib']:.1f} narrow), upload {time.time() - t0:.2f} s")
    b0 = reads[:BATCH]
    with Recorder() as rec:
        aln_w.align_batch_bam([q for _, q in b0], [n for n, _ in b0],
                              sam=True)
    if not rec.k2 or any(r[0].blocks.dtype != torch.int64 for r in rec.k2):
        raise AssertionError("wide path: K2 not called on the wide index")
    w_times = check_time_recorded(rec, "wide path (one batch)", narrow["load_ns"],
                                  card)
    del rec

    class Read:
        __slots__ = ("name", "seq")

        def __init__(self, n, q):
            self.name, self.seq = n, q

    stream = [Read(n, q) for n, q in reads]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.time()
    outs_w = list(aln_w.align_stream_bam(iter(stream), batch_size=BATCH,
                                         sam=True))
    torch.cuda.synchronize()
    wall = time.time() - t0
    wide_launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    for k in cuda_lib.MAIN_PATH:
        if wide_launches[k] <= 0:
            raise AssertionError(f"wide path: kernel {k} not launched")
    same = len(outs_w) == len(outs) and all(
        pw == pn and np.array_equal(cw, cn)
        for (_, pw, cw), (_, pn, cn) in zip(outs_w, outs))
    if not same:
        raise AssertionError("wide path: records differ from the narrow "
                             "path's")
    n_rec = sum(int(c.sum()) for _, _, c in outs_w)
    log(f"wide: main path wide=True: {len(reads)} reads in {wall:.2f} s = "
        f"{len(reads) / wall:.0f} reads/s (narrow {narrow['reads_s']:.0f}); "
        f"SAM == the narrow path's byte for byte ({n_rec} records); "
        f"launches {wide_launches}; peak device memory {peak:.0f} MiB "
        f"(narrow {narrow['peak_mib']:.0f}) [{card}]")
    del aln_w, outs_w

    # ---- sharded ---------------------------------------------------------
    contigs = bam_contigs(genome)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_wide_")
    try:
        t0 = time.time()
        sidx = ShardedFMIndex.construct(contigs, max_shard_bp=SHARD_BP)
        prefix = os.path.join(workdir, "ref.fa")
        sidx.write(prefix)
        t_index = time.time() - t0
        if sidx.n_shards < 2:
            raise AssertionError("sharded: fewer than 2 shards")
        fq = os.path.join(workdir, "reads.fq")
        sub = reads[:SHARD_READS]
        write_fastq(fq, sub)
        out_sam = os.path.join(workdir, "sharded.sam")
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        t0 = time.time()
        if cli.main(["align", "-F", fq, "-G", prefix, "-o", out_sam]) != 0:
            raise AssertionError("sharded: seqtools align failed")
        torch.cuda.synchronize()
        t_align = time.time() - t0
        sh_launches = dict(cuda_lib.LAUNCHES)
        for k in cuda_lib.MAIN_PATH:
            if sh_launches[k] <= 0:
                raise AssertionError(f"sharded: kernel {k} not launched")
        with open(out_sam) as fh:
            lines = fh.read().splitlines()
        body = [ln for ln in lines if not ln.startswith("@")]
        single = FMIndex.construct(contigs)
        aln1 = BWAAligner(single, device=dev)
        hdr = single.header_from_index()
        want = []
        for i in range(0, len(sub), 512):
            chunk = sub[i:i + 512]
            for recs in aln1.align_batch([q for _, q in chunk],
                                         [n for n, _ in chunk]):
                mark_supplementary(recs)
                want += [r.to_sam(hdr) for r in recs]

        same, flips = sharded_vs_single(body, want)
        head = "".join(ln + "\n" for ln in lines if ln.startswith("@"))
        if head != single.sam_header_text():
            raise AssertionError("sharded: header differs from the single "
                                 "index's")
        log(f"wide: sharded index of {sidx.n_shards} shards "
            f"({[s.l_pac for s in sidx.shards]} bp; construct + write "
            f"{t_index:.1f} s): seqtools align of {len(sub)} reads on the "
            f".shards prefix {t_align:.2f} s = {len(sub) / t_align:.0f} reads/s;"
            f" {len(body)} records: {same} reads == the single index's "
            f"(flag, place, MAPQ, CIGAR, NM, AS), {flips} with the same "
            f"alignments and another of equal AS primary; launches "
            f"{sh_launches} [{card}]")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"wide phase: {time.time() - t_phase:.1f} s [{card}]")
    return {k: dict(wide=path_fields(wide_launches[k], w_times.get(k, ())),
                    sharded=path_fields(sh_launches[k]))
            for k in PATH_KERNELS}


# ---------------------------------------------------------------------------
# parallel: meshes, the data-parallel steps, two ranks, the dry run
# ---------------------------------------------------------------------------

RANK_TIMEOUT = 300                 # s a rank of the two-rank run may take


def sam_by_name(lines) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    for ln in lines:
        out.setdefault(ln.split("\t", 1)[0], []).append(ln)
    return out


def mesh_checks(mesh, idx, stream, main_payloads, golden, rep, card: str,
                record: bool) -> dict:
    """One mesh: the first reads of the main path through
    ``align_stream_bam`` (counters reset just before and read just
    after; SAM == the main phase's byte for byte), the repeat corpus
    through ``align_batch`` (the classic path, its narrow global DP split
    over the mesh; records == the golden SAM), and with ``record`` one
    batch whose K1 and K2 calls are held against their plain versions."""
    what = f"mesh {[str(d) for d in mesh.devices]}"
    aln = BWAAligner(idx, mesh=mesh)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.time()
    outs = list(aln.align_stream_bam(iter(stream), batch_size=BATCH,
                                     sam=True))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    for k in cuda_lib.MAIN_PATH:
        if launches[k] <= 0:
            raise AssertionError(f"{what}: kernel {k} not launched")
    if [p for _, p, _ in outs] != main_payloads:
        raise AssertionError(f"{what}: SAM differs from the main path's")
    log(f"{what}: {len(stream)} reads through align_stream_bam in "
        f"{wall:.2f} s = {len(stream) / wall:.0f} reads/s; SAM == the main "
        f"path's byte for byte; launches {launches} [{card}]")
    g_idx, seqs, names = rep
    r_aln = BWAAligner(g_idx, mesh=mesh)
    cuda_lib.reset_launches()
    t0 = time.time()
    recs = r_aln.align_batch(seqs, names)
    torch.cuda.synchronize()
    wall_r = time.time() - t0
    r_launches = dict(cuda_lib.LAUNCHES)
    hdr = g_idx.header_from_index()
    if [r.to_sam(hdr) for rs in recs for r in rs] != golden:
        raise AssertionError(f"{what}: the repeat corpus's records differ "
                             "from the golden SAM")
    fb = r_aln.stats["fused_overflow_fallback"]
    if fb != 1 or any(r_launches[k] <= 0 for k in cuda_lib.MAIN_PATH):
        raise AssertionError(f"{what}: repeat corpus did not take the "
                             f"classic path on the kernels ({fb}, "
                             f"{r_launches})")
    log(f"{what}: the {len(seqs)}-read repeat corpus through align_batch "
        f"(classic path: stage 1 whole on the first device, the narrow "
        f"global DP split over the mesh) "
        f"in {wall_r:.2f} s; records == {GOLDEN_REPEAT} ({len(golden)} "
        f"lines); launches {r_launches} [{card}]")
    if record:
        b0 = stream[:BATCH]
        with Recorder() as rec:
            aln.align_batch_bam([r.seq for r in b0], [r.name for r in b0],
                                sam=True)
        if not rec.k1 or not rec.k2:
            raise AssertionError(f"{what}: recorded no K1 or K2 call")
        check_recorded(rec, f"{what} (one {BATCH}-read batch)")
    return dict(launches=launches, reads_s=len(stream) / wall)


def parallel_phase(genome: str, idx, reads, main_payloads, narrow: dict,
                   card: str):
    """Meshes over the host's cards and of two entries on one card, the
    data-parallel seed and extension steps, the scaling report (replicas
    on one card), two ranks of ``parallel.multihost`` on one card, and
    ``dryrun_multichip`` over every card."""
    from seqlib_tpu_torch.ops.fm import collect_seeds
    from seqlib_tpu_torch.ops.sw import extend_rect
    from seqlib_tpu_torch.parallel import (make_mesh, sharded_extend_step,
                                           sharded_seed_step)
    from seqlib_tpu_torch.parallel.dryrun import dryrun_multichip
    from seqlib_tpu_torch.parallel.scaling import measure_scaling

    class Read:
        __slots__ = ("name", "seq")

        def __init__(self, n, s):
            self.name, self.seq = n, s

    t_phase = time.time()
    n_main = len(main_payloads) * BATCH
    stream = [Read(n, s) for n, s in reads[:n_main]]
    r_genome = make_repeat_genome()
    r_reads = make_repeat_reads(r_genome)
    rep = (FMIndex.construct([("rep1", r_genome)]),
           [s for _, s in r_reads], [n for n, _ in r_reads])
    with open(GOLDEN_REPEAT) as f:
        golden = [l for l in f.read().splitlines() if not l.startswith("#")]

    # ---- meshes ------------------------------------------------------------
    cards = make_mesh()
    log(f"parallel: make_mesh() over every visible card: "
        f"{cards.shape['dp']} entries {[str(d) for d in cards.devices]}")
    one_card = make_mesh(2, device="cuda:0")
    mesh_launches = {k: 0 for k in cuda_lib.LAUNCHES}
    mesh_rs = {}
    for mesh, record in ((cards, False), (one_card, True)):
        out = mesh_checks(mesh, idx, stream, main_payloads, golden, rep,
                          card, record)
        mesh_rs[len(mesh.devices)] = out["reads_s"]
        for k, v in out["launches"].items():
            mesh_launches[k] += v
    log(f"parallel: main path {narrow['reads_s']:.0f} reads/s (32,768 "
        f"reads, one card); the first {n_main} reads on {cards.shape['dp']} "
        f"card(s) {mesh_rs[cards.shape['dp']]:.0f}, on 2 entries of cuda:0 "
        f"{mesh_rs[2]:.0f} reads/s [{card}]")

    # ---- the data-parallel steps on bench.py's 1024 lanes ------------------
    dev0 = one_card.devices[0]
    fm0 = DeviceFMIndex.from_host(idx, device=dev0)
    aln1 = BWAAligner(idx, device=dev0)
    enc, lens = aln1._encode_batch([r.seq for r in stream[:bench_sw.B]])
    lens = lens.astype(np.int32)
    args = bench_sw.bench_inputs(dev0)
    seed_step = sharded_seed_step(fm0, one_card)
    steps = {band: sharded_extend_step(one_card, zdrop=bench_sw.ZDROP,
                                       band=band) for band in (0, 100)}
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    seeds, stats = seed_step(enc, lens)
    ext = {band: step(*args) for band, step in steps.items()}
    torch.cuda.synchronize()
    step_launches = dict(cuda_lib.LAUNCHES)
    if step_launches["sw_extend_rect"] <= 0 or \
            step_launches["sw_extend"] <= 0:
        raise AssertionError("parallel: the extension steps launched no K3 "
                             f"or K1 ({step_launches})")
    for k, v in step_launches.items():
        mesh_launches[k] += v
    e_t, l_t = torch.from_numpy(enc).to(dev0), torch.from_numpy(lens).to(dev0)
    one = collect_seeds(fm0, e_t, l_t)
    plain = collect_seeds(DeviceFMIndex.from_host(idx, device="cpu"),
                          e_t.cpu(), l_t.cpu())
    keys = ("qbeg", "qend", "intv_l", "intv_sz", "n_seeds")
    err = max(max_abs_diff(seeds, one, keys),
              max_abs_diff({k: v.cpu() for k, v in seeds.items()}, plain,
                           keys))
    if err or int(stats[0]) != int(one["n_seeds"].sum()) or int(stats[1]) \
            != int((one["qend"] - one["qbeg"]).sum()):
        raise AssertionError(f"parallel: sharded_seed_step differs ({err})")
    ext_err = {}
    for band, (out, total) in ext.items():
        kw = dict(zdrop=bench_sw.ZDROP)
        if band:
            one = sw_cuda.extend_batch_banded(*args, band=band, **kw)
            want = extend_batch(*args, band=band, **kw)
        else:
            one = sw_cuda.extend_batch_rect(*args, **kw)
            want = extend_rect(*args, **kw)
        ext_err[band] = max(max_abs_diff(out, one), max_abs_diff(out, want))
        if ext_err[band] or int(total) != int(want["score"].sum()):
            raise AssertionError(f"parallel: sharded_extend_step band "
                                 f"{band} differs ({ext_err[band]})")
    log(f"parallel: sharded_seed_step ({bench_sw.B} main-path reads, "
        f"{int(stats[0])} seeds covering {int(stats[1])} bases) and "
        f"sharded_extend_step on bench.py's {bench_sw.B} lanes (band 0: "
        f"K3; band 100: K1; zdrop {bench_sw.ZDROP}) on 2 entries of cuda:0 "
        f"== one device == the plain versions (tolerance 0); launches "
        f"{step_launches}")

    # ---- reads/s over mesh sizes: replicas on one card ---------------------
    enc4, lens4 = aln1._encode_batch([r.seq for r in stream[:BATCH]])
    rows = measure_scaling(idx, enc4, lens4, sizes=[1, 2], iters=3,
                           device="cuda:0")
    log(f"parallel: measure_scaling at sizes [1, 2] of one card (replicas "
        f"of a {BATCH}-read batch on cuda:0, not multi-GPU scaling): "
        f"{rows} [{card}]")

    # ---- two ranks on one card ---------------------------------------------
    here = os.path.dirname(os.path.abspath(__file__))
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        out_bam = os.path.join(workdir, "ranks.bam")
        env = dict(os.environ, PYTHONPATH=here)
        argv = [sys.executable, "-m", "seqlib_tpu_torch.parallel.multihost",
                "--coordinator", f"127.0.0.1:{port}", "--world", "2",
                "--out", out_bam, "--device", "cuda:0",
                "--genome-bp", str(len(genome)), "--reads", str(len(reads)),
                "--take", str(n_main), "--batch", str(BATCH)]
        t0 = time.time()
        procs = [subprocess.Popen(argv + ["--rank", str(r)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=env, cwd=here) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        t_ranks = time.time() - t0
        for r, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"parallel: rank {r} exited "
                                     f"{p.returncode}:\n{text[-3000:]}")
        res = [json.loads(text.strip().splitlines()[-1]) for text in logs]
        totals = {(r["total_records"], r["total_reads"]) for r in res}
        if len(totals) != 1:
            raise AssertionError(f"parallel: the ranks' totals differ "
                                 f"({totals})")
        total_records, total_reads = totals.pop()
        if total_reads != n_main or total_reads != sum(
                r["local_reads"] for r in res) or total_records != sum(
                r["local_records"] for r in res):
            raise AssertionError("parallel: totals != the parts' sums")
        hdr = idx.header_from_index()
        parts: dict[str, list[str]] = {}
        for r in res:
            rd = BamReader(r["part"])
            for rec in iter(rd.next, None):
                parts.setdefault(rec.qname, []).append(rec.to_sam(hdr))
        want = sam_by_name(
            "".join(p.decode() for p in main_payloads).splitlines())
        if parts != want:
            raise AssertionError("parallel: the ranks' parts differ from "
                                 "one process's records")
        span = max(r["t_end"] for r in res) - min(r["t_start"] for r in res)
        rank_launches = {k: sum(r["launches"][k] for r in res)
                         for k in cuda_lib.LAUNCHES}
        for r in res:
            log(f"parallel: rank {r['rank']} of 2 on {r['device']}: "
                f"{r['local_reads']} reads, {r['local_records']} records "
                f"in {r['wall_s']:.2f} s = {r['reads_s']:.0f} reads/s; peak "
                f"device memory {r['peak_mib']:.0f} MiB [{card}]")
        log(f"parallel: two ranks (gloo, one card): totals {total_records} "
            f"records, {total_reads} reads on both == the parts' sums; the "
            f"parts merged by read name == one process's records; combined "
            f"{total_reads / span:.0f} reads/s over {span:.2f} s (one "
            f"process: main path {narrow['reads_s']:.0f} reads/s); the "
            f"ranks' run {t_ranks:.1f} s with start-up; launches "
            f"{rank_launches} [{card}]")
        for k in cuda_lib.MAIN_PATH:
            if rank_launches[k] <= 0:
                raise AssertionError(f"parallel: the ranks launched no {k}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # ---- the dry run over every card ---------------------------------------
    dry = dryrun_multichip(torch.cuda.device_count())
    log(f"parallel: dryrun_multichip({torch.cuda.device_count()}): {dry}")
    log(f"parallel phase: {time.time() - t_phase:.1f} s [{card}]")
    return mesh_launches, rank_launches


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
        for kern, regs, frame, st, ld in cuda_lib.ptxas_report(rep):
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
    narrow = dict(reads_s=n_reads / wall,
                  peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                  blocks_mib=aln.fm.blocks.numel() * 4 / 2**20)
    log(f"main path: {n_reads} reads in {len(outs)} batches through "
        f"align_stream_bam on {name}: {wall:.2f} s = "
        f"{n_reads / wall:.0f} reads/s [{card}]")
    log(f"launches on the main path: {launches} "
        f"(per batch: { {k: v / len(outs) for k, v in launches.items()} })")
    for k in cuda_lib.MAIN_PATH:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main "
                                 "path")
    if launches["sa_walk"]:
        raise AssertionError("the walk kernel ran on a full SA")
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

    kernels["sa_walk"] = {}      # its fields come from the cli phase
    for k, v in kernels.items():
        v["launches"] = int(launches[k])

    # ---- overflow path and object API ----------------------------------------
    over_launches = check_overflow_path(dev, card)

    # ---- long reads, pairs, K1/K2 at long shapes -----------------------------
    t_new = time.time()
    long_launches, long_times = long_read_phase(aln, genome, card, load_ns)
    pair_launches, pairs = paired_phase(aln, genome, card)
    # the bam, cli and records phases share one work directory: records
    # reads the bam phase's sorted BAM and the cli phase's files
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        bam_launches, bam_out = bam_phase(genome, reads, dev, card, workdir)
        t0 = time.time()
        long_edge_phase(dev, rec.k2[0][0], genome, card)
        log(f"long edge phase: {time.time() - t0:.1f} s")
        for k in PATH_KERNELS:
            kernels[k]["by_path"] = dict(
                main=path_fields(kernels[k]["launches"]),
                overflow=path_fields(over_launches[k]),
                long=path_fields(long_launches[k], long_times.get(k, ())),
                paired=path_fields(pair_launches[k]),
                bam=path_fields(bam_launches[k]))
        log(f"long-read, paired, bam and long edge phases: "
            f"{time.time() - t_new:.1f} s"
            f" [{card}]")

        # ---- BFC and assembly, the command line, records -------------------
        t0 = time.time()
        asm_launches, asm_contigs = assembly_local_phase(genome, card)
        log(f"assembly-local phase: {time.time() - t0:.1f} s")
        t2 = time.time()
        cli_launches, walk = cli_phase(genome, reads, pairs, asm_contigs,
                                       bam_out, card, workdir, load_ns)
        del bam_out
        kernels["sa_walk"].update(walk)
        for k in PATH_KERNELS:
            kernels[k]["by_path"]["cli"] = path_fields(cli_launches[k])
        log(f"cli phase: {time.time() - t2:.1f} s [{card}]")
        t2 = time.time()
        records_launches = records_phase(card, workdir)
        for k in PATH_KERNELS:
            kernels[k]["by_path"]["records"] = path_fields(
                records_launches[k])
        log(f"records phase: {time.time() - t2:.1f} s [{card}]")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    t1 = time.time()
    bfc_launches = bfc_genome_phase(genome, card)
    log(f"bfc-genome phase: {time.time() - t1:.1f} s; both assembly phases, "
        f"the cli and records phases {time.time() - t0:.1f} s [{card}]")
    asm_launches = {k: asm_launches[k] + bfc_launches[k]
                    for k in cuda_lib.LAUNCHES}

    # ---- wide: int64 ranks, wide=True main path, sharded ---------------------
    narrow["load_ns"] = load_ns
    wide_paths = wide_phase(genome, idx, reads, outs, narrow, dev, card)
    main_payloads = [p for _, p, _ in outs[:MESH_READS // BATCH]]
    del outs
    for k in PATH_KERNELS:
        kernels[k]["by_path"].update(wide_paths[k])

    # ---- parallel: meshes, the data-parallel steps, two ranks, dry run -----
    mesh_launches, rank_launches = parallel_phase(genome, idx, reads,
                                                  main_payloads, narrow, card)
    del main_payloads
    for k in PATH_KERNELS:
        kernels[k]["by_path"].update(
            mesh=path_fields(mesh_launches[k]),
            multihost=path_fields(rank_launches[k]))

    # ---- K3, K4, K5 on the extension bench path --------------------------------
    t0 = time.time()
    bench = bench_sw.run(dev, log=log)
    for k in bench_sw.RECT_KERNELS:
        kernels[k] = dict(bench[k], by_path=dict(
            bench=path_fields(bench[k]["launches"])))
    kernels["K3"]["by_path"]["mesh"] = path_fields(
        mesh_launches[bench_sw.RECT_KERNELS["K3"].counter])
    for k, v in kernels.items():
        counter = bench_sw.RECT_KERNELS[k].counter \
            if k in bench_sw.RECT_KERNELS else k
        v["by_path"]["assembly"] = path_fields(asm_launches[counter])
    log(f"extension bench (checks + timing): {time.time() - t0:.1f} s; "
        "launches on the bench path: "
        f"{ {k: bench[k]['launches'] for k in bench_sw.RECT_KERNELS} }")

    kl = [dict(name=v["name"], route=v["route"], source=v["source"],
               replaces=v["replaces"], launches=v["launches"],
               max_abs_err=v["max_abs_err"], ms=v["ms"],
               event_ms=v["event_ms"], plain_ms=v["plain_ms"],
               bound_ms=v["bound_ms"], bound_by=v["bound_by"],
               library_ms=v["library_ms"],
               **({"by_path": v["by_path"]} if "by_path" in v else {}))
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
