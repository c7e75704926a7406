"""BWA-MEM-style single-end aligner (counterpart of
seqlib_tpu/align/aligner.py).

``align_batch_bam`` / ``align_stream_bam`` encode a batch, run the whole
device program (``device_full.align_full``: SMEM seeding on kernel K2,
SA locate, chaining, banded extension on kernel K1, dedup and primary
marking, global DP and traceback), then compute float64 MAPQ on the
host and emit SAM/BAM records through the native C++ encoder
(``native/bamenc.cpp``).  ``align_batch`` / ``align_sequence`` (the
object API) return :class:`~seqlib_tpu_torch.core.record.BamRecord`
lists from the same device program.  Every output is byte-identical to
``seqlib_tpu``'s same entry points.

A batch whose extension DP rows overflow ``dp_rows(B)`` reruns through
the classic path (``_collect_regions``: seed, chain and extend with an
uncompacted re-extension, host dedup and primary marking, then
``_regions_to_hits``) and is serialised through the object API, as the
JAX package does; ``stats["fused_overflow_fallback"]`` counts it.

Every route builds one hit format, the columns ``native.bam_encode_hits``
takes: ``_host_cols`` from the fused program's outputs and
``_regions_to_hits`` from region lists (classic, long, sharded, rescued
mates), both through ``_hit_cols`` (contig, clips, ``approx_mapq``) and
``_window_dp`` (the host global DP); ``_cols_to_hit_dicts`` turns the
columns into the object API's per-read dicts.

``align_batch`` (and so ``align_sequence``) sends a batch holding a read
longer than ``BWAAligner.LONG_READ_BP`` (a class attribute, read through
the instance, so a subclass or an instance may move the cut-over) down
the long-read path: seeding on K2,
SA locate, host chaining (``align.chain``), extension on K1, then the
classic path's dedup, global DP and records.  ``align_batch_bam`` and
``align_stream_bam`` raise :class:`FusedOverflowError` for such reads,
as the JAX package's native emission does not route them either.

An index whose 2L text is 2^31 or more (or any index, with
``wide=True``) runs the same code with int64 checkpoint rows, K2's
int64 instantiation and an int64 region block (``ops.fm``,
``device_full``); the JAX package's hi/lo twins of these modules have no
counterpart here, as the card has native int64.

``BWAAligner(index, mesh=...)`` (a ``parallel.Mesh``) splits every batch
over the mesh's entries: the index and the 2L text are copied once to
each distinct device, the encoded batch (padded to a multiple of the
mesh size) is cut into contiguous equal slices, and each entry runs the
fused program on its slice on a host thread of its own, under its
device's guard, all at once; the host merges the slices' columnar hits.
When any slice overflows its extension DP rows (``dp_rows(B / n)``, as
the JAX package's mesh path), the whole batch takes the classic path,
whose narrow-band global DP is split over the mesh the same way.  Its
stage 1 runs on the whole batch on the mesh's first device: stage 1's
caps are batch-wide (which chains an overflowing batch leaves
unextended decides each read's best region and so its escapee
extensions), so a split stage 1 gives other regions than one device
does on an overflowing batch (16 of the 1000-read repeat corpus's reads
on two slices).  Wide-band rows and long reads stay on the first device
too.  The JAX package sends a mesh through the classic path only; the
port's records equal its single-device run either way.
"""

from __future__ import annotations

import collections
import concurrent.futures as _fut
import itertools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import native as _native
from .. import profiling
from ..core.cigar import Cigar, CigarField
from ..core.record import FREVERSE, FSECONDARY, BamRecord
from ..core.seq import NT4_TABLE, revcomp
from ..core.unaligned import UnalignedSequence
from ..device import resolve_device, run_on_devices
from ..index.pack import both_strands
from ..io.bam import encode_record
from ..ops.fm import DeviceFMIndex
from .device_full import (F_DPROW, F_FLAGS, F_QB, F_QE, F_RB, F_RE,
                          F_SCORE, F_SEC, F_SUB, F_SUBN, FLAG_EMIT,
                          FLAG_OVER, FLAG_PERFECT, FLAG_WIDE, NFIELD,
                          _hash64, align_full)
from .chain import chain_batch
from .device_pipeline import (ESC_SLOTS, RUN_LEN_MASK, RUN_SHIFT, dp_rows,
                              dp_widths, extend_chains,
                              global_and_traceback, seed_and_locate,
                              seed_chain_extend)
from .options import AlignerOptions

MAX_SEEDS = 16          # per read from the seed scan
MAX_OCC_LOCATE = 16     # occurrences located per seed
MAX_CHAINS = 4          # chains extended per read
REGION_SLOTS = MAX_CHAINS + ESC_SLOTS
MAX_REGS = 8            # alignment regions kept per read (classic path)


class FusedOverflowError(RuntimeError):
    """A batch given to ``align_batch_bam`` or ``align_stream_bam`` holds
    reads longer than the aligner's ``LONG_READ_BP``: past 1024 bp the
    fused path's packed chain keys cannot order them.  ``align_batch``
    takes such reads.  Nothing is returned."""


@dataclass
class AlnReg:
    """mem_alnreg_t equivalent (coordinates in 2L text space).

    ``shard``/``gb``/``ge`` are used only by the sharded-index path
    (``align.sharded``): rb/re stay shard-local (they index that shard's
    text) while gb/ge are global pseudo-2L keys for the cross-shard
    dedup and overlap tests."""
    rb: int
    re: int
    qb: int
    qe: int
    score: int
    seedcov: int
    frac_rep: float
    sub: int = 0
    csub: int = 0
    sub_n: int = 0
    secondary: int = -1
    shard: int = 0
    gb: int = 0
    ge: int = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket(n: int, mn: int = 64) -> int:
    """Batch bucket: powers of two up to 512, then multiples of 512."""
    b = mn
    while b < n and b < 512:
        b *= 2
    if n <= b:
        return b
    return (n + 511) // 512 * 512


def _fetch_runs(run_off, runs):
    """``global_and_traceback``'s run offsets and words, on the host: the
    offsets, then only the ``run_off[-1]`` words they use."""
    off = run_off.cpu().numpy()
    return off, runs[:int(off[-1])].cpu().numpy()


def _split_runs(words: np.ndarray):
    """Run words -> (run_ops uint8, run_lens int32), the columns'
    format (0=M 1=D 2=I)."""
    w = words.view(np.uint32)
    return ((w >> RUN_SHIFT).astype(np.uint8),
            (w & RUN_LEN_MASK).astype(np.int32))


def _windows(seq: np.ndarray, start: np.ndarray, n: np.ndarray,
             width: int) -> np.ndarray:
    """``seq[start:start + n]`` of each row, padded with code 4 to
    ``width`` codes: uint8 [rows, width]."""
    j = np.arange(width)
    out = seq[np.minimum(start[:, None] + j, seq.size - 1)]
    out[j >= n[:, None]] = 4
    return out


def approx_mapq(opt: AlignerOptions, score, sub, sub_n, length, frac_rep):
    """bwa's mem_approx_mapq_se in float64, over arrays of regions:
    ``sub`` the best suboptimal score (0 for none: min_seed_len * a is
    taken), ``sub_n`` the suboptimals near the score, ``length``
    max(query span, target span), ``frac_rep`` the read's repeat
    fraction.  bwa's csub is never set here, so max(sub, csub) is sub."""
    sub = np.where(sub > 0, sub, opt.min_seed_len * opt.a).astype(np.float64)
    length = np.maximum(length, 1).astype(np.float64)
    ident = 1.0 - (length * opt.a - score) / (opt.a + opt.b) / length
    tmp = np.where(length < opt.mapQ_coef_len, 1.0,
                   opt.mapQ_coef_fac / np.log(np.maximum(length, 2.0)))
    tmp = tmp * ident * ident
    mq = (6.02 * (score - sub) / opt.a * tmp * tmp + 0.499).astype(np.int64)
    mq -= np.where(sub_n > 0,
                   (4.343 * np.log(sub_n + 1) + 0.499).astype(np.int64), 0)
    mq = np.clip(mq, 0, 60)
    mq = (mq * (1.0 - frac_rep) + 0.499).astype(np.int64)
    return np.where(sub >= score, 0, mq)


class _Slices(list):
    """Per-slice results of one batch split over a mesh, in entry order."""


def _merge_cols(parts: list[dict], rows: int = 0) -> dict:
    """Columnar hits of consecutive ``rows``-read slices -> one batch's:
    read indices offset by each slice's first row (not at all with
    ``rows`` 0: parts of the same reads), CIGAR run offsets by the runs
    of the parts before it."""
    out = {}
    for k in parts[0]:
        out[k] = np.concatenate([c[k] for c in parts])
    read_off, run_off = [], []
    base = 0
    for i, c in enumerate(parts):
        read_off.append(np.full(c["read_idx"].size, i * rows, np.int32))
        run_off.append(np.where(c["cig_n"] > 0, base, 0).astype(np.int64))
        base += c["run_ops"].size
    out["read_idx"] = out["read_idx"] + np.concatenate(read_off)
    out["cig_off"] = out["cig_off"] + np.concatenate(run_off)
    return out


def _take_cols(cols: dict, sel: np.ndarray) -> dict:
    """The hits ``sel`` picks (a mask, or indices in their order); the
    run arrays stay shared."""
    out = dict(cols)
    for k, v in cols.items():
        if k not in ("run_ops", "run_lens"):
            out[k] = v[sel]
    return out


class BWAAligner:
    """Single-end aligner over an :class:`~seqlib_tpu_torch.index.FMIndex`.

    ``device`` is where the device program runs: ``"cuda"`` (default,
    the hand-written kernels) or ``"cpu"`` (their plain PyTorch
    versions).  ``wide`` picks the int64 index path: by default an index
    whose 2L text is 2^31 or more takes it, and ``wide=True`` forces it
    on any index.  ``mesh`` (a ``parallel.Mesh``) splits every batch
    over its entries; ``device`` is then the mesh's first device.
    Construction puts the index (``DeviceFMIndex.from_host``) and the 2L
    text on the device; while the tracer is on, the text's copy is the
    span ``index.upload_text`` (counter ``index.text_bytes``).
    Scoring options are set through the ``set_*`` methods
    (reference-style names) or ``self.options``."""

    LONG_READ_BP = 1024   # the fused path's packed chain keys cap reads here
    mesh = None

    def __init__(self, index, options: AlignerOptions | None = None,
                 wide: bool | None = None, device="cuda", mesh=None):
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None \
            else resolve_device(device)
        self.index = index
        self.options = options or AlignerOptions()
        self.wide = index.seq_len >= 2**31 if wide is None else bool(wide)
        self.fm = DeviceFMIndex.from_host(index, device=self.device,
                                          wide=self.wide)
        with profiling.span("index.upload_text"):
            self.text = both_strands(index.ref.codes)
            self.text_t = torch.from_numpy(self.text).to(self.device)
            profiling.placed("index.text_bytes", self.text_t)
        # the index and the 2L text on each of the mesh's devices
        self._on = {self.device: (self.fm, self.text_t)}
        for dev in (mesh.distinct() if mesh is not None else ()):
            if dev not in self._on:
                self._on[dev] = (self.fm.to(dev), self.text_t.to(dev))
        # truncation telemetry; align_stream_bam's host threads update it
        self.stats = dict(seeds_at_cap=0, occ_clipped=0, chains_at_cap=0,
                          regs_truncated=0, regions_widened=0,
                          regions_dropped_wide=0, fused_overflow_fallback=0,
                          escapees_deferred=0, rescue_windows_dropped=0)
        self._stats_lock = threading.Lock()
        self._copy_comment = False
        self._ann_offs = index.contig_offsets()
        self._ann_lens = index.contig_lengths()
        self._names = index.contig_names()
        self._ref_blob_cache = None

    @property
    def n_shards(self) -> int:
        """Slices a batch is split into: the mesh's size, else 1."""
        return self.mesh.shape["dp"] if self.mesh is not None else 1

    def reset_stats(self):
        with self._stats_lock:
            for k in self.stats:
                self.stats[k] = 0

    def _count(self, **inc):
        with self._stats_lock:
            for k, v in inc.items():
                self.stats[k] += int(v)

    # -- option setters forwarded (reference-style names) -------------------

    def set_gap_open(self, v): self.options.set_gap_open(v)
    def set_gap_extension(self, v): self.options.set_gap_extension(v)
    def set_mismatch_penalty(self, v): self.options.set_mismatch_penalty(v)
    def set_zdropoff(self, v): self.options.set_zdropoff(v)
    def set_a_score(self, v): self.options.set_a_score(v)
    def set_3prime_clipping_penalty(self, v):
        self.options.set_3prime_clipping_penalty(v)
    def set_5prime_clipping_penalty(self, v):
        self.options.set_5prime_clipping_penalty(v)
    def set_bandwidth(self, v): self.options.set_bandwidth(v)
    def set_reseed_trigger(self, v): self.options.set_reseed_trigger(v)
    def set_copy_comment(self, v: bool): self._copy_comment = v

    # ------------------------------------------------------------------
    # device program
    # ------------------------------------------------------------------

    def _encode_batch(self, seqs: list[str]):
        L = _round_up(max(len(s) for s in seqs), 32)
        Bp = _round_up(_bucket(len(seqs), mn=8), self.n_shards)
        lens = np.zeros(Bp, np.int64)
        lens[:len(seqs)] = [len(s) for s in seqs]
        enc = np.full((Bp, L), 4, np.uint8)
        codes = NT4_TABLE[np.frombuffer("".join(seqs).encode(), np.uint8)]
        enc[np.arange(L, dtype=np.int64)[None, :] < lens[:, None]] = codes
        return enc, lens

    def _dispatch_full(self, enc: np.ndarray, lens: np.ndarray):
        """Run the whole device program for one encoded batch; returns
        ``align_full``'s (regions, snm, run_off, runs) tensors on the
        aligner's device, or on a mesh one such tuple per slice
        (``_Slices``)."""
        if int(lens.max(initial=0)) > self.LONG_READ_BP:
            raise FusedOverflowError(
                f"reads longer than {self.LONG_READ_BP} bp exceed the fused "
                "path's packed chain keys: align them with align_batch, "
                "which routes them through the long-read path")
        if self.mesh is None:
            return self._full_program(self.fm, self.text_t, enc, lens,
                                      self.device)
        # each entry's slice (contiguous rows) on its own host thread
        b = enc.shape[0] // self.n_shards

        def one(k, dev):
            fm, text = self._on[dev]
            return self._full_program(fm, text, enc[k * b:(k + 1) * b],
                                      lens[k * b:(k + 1) * b], dev)

        return _Slices(self.mesh.run(
            [(lambda k=k, d=d: one(k, d))
             for k, d in enumerate(self.mesh.devices)]))

    def _full_program(self, fm, text, enc, lens, dev):
        """``align_full`` of one encoded batch on ``dev``."""
        opt = self.options
        enc_lens = np.concatenate(
            [enc, lens.astype("<u4").view(np.uint8).reshape(-1, 4)], axis=1)
        with profiling.upload("reads"):
            enc_lens = torch.from_numpy(enc_lens).to(dev)
        return align_full(
            fm, text, enc_lens, **self._stage1_kwargs(), T=opt.T,
            mask_level=opt.mask_level, mask_level_redun=opt.mask_level_redun,
            glob_band=2 * opt.w + 8)

    def _stage1_kwargs(self) -> dict:
        """Seed, chain and extension options shared by the fused program
        and the classic path's ``seed_chain_extend``."""
        opt = self.options
        return dict(
            l_pac=self.index.l_pac, max_seeds=MAX_SEEDS,
            min_seed_len=opt.min_seed_len, max_occ=opt.max_occ,
            k_occ=MAX_OCC_LOCATE, band=opt.w,
            max_chain_gap=opt.max_chain_gap, drop_ratio=opt.drop_ratio,
            max_chains=MAX_CHAINS, o_del=opt.o_del, e_del=opt.e_del,
            o_ins=opt.o_ins, e_ins=opt.e_ins, match=opt.a,
            mismatch=opt.b, pen_clip5=opt.pen_clip5,
            pen_clip3=opt.pen_clip3, w=opt.w, zdrop=opt.zdrop,
            split_len=opt.split_len, split_width=opt.split_width,
            min_chain_weight=opt.min_chain_weight,
            max_chain_extend=opt.max_chain_extend,
            max_mem_intv=opt.max_mem_intv)

    # ------------------------------------------------------------------
    # classic path: per-read regions, host dedup, global DP per region
    # ------------------------------------------------------------------

    def _dispatch_stage1(self, enc: np.ndarray, lens: np.ndarray) -> dict:
        """One ``seed_chain_extend`` (seed, locate, chain, compacted
        extension) of an encoded batch, whole, on the aligner's (a
        mesh's first) device, where its tensors stay."""
        dev = self.device
        return seed_chain_extend(
            self.fm, self.text_t, torch.from_numpy(enc).to(dev),
            torch.from_numpy(lens.astype(np.int64)).to(dev),
            **self._stage1_kwargs())

    def _collect_regions(self, enc: np.ndarray, lens: np.ndarray,
                         dedup: bool = True, stage1: dict | None = None
                         ) -> list[list[AlnReg]]:
        """enc [B, L] nt4 codes (4-padded) -> per-read region lists
        (deduped, primary/secondary marked): ``_dispatch_stage1`` (or
        ``stage1``, its result), then, when the batch has more
        non-trivial chains than DP rows, an uncompacted re-extension of
        every kept chain."""
        B = enc.shape[0]
        out = self._dispatch_stage1(enc, lens) if stage1 is None else stage1
        out = {k: v.cpu().numpy() if torch.is_tensor(v) else v
               for k, v in out.items()}
        frac_reps = out["rep_cov"] / np.maximum(lens, 1)
        keep = out["keep"]
        qb, qe = out["qb"], out["qe"]
        rb, re = out["rb"], out["re"]
        score, weight = out["score"], out["weight"]
        if out["n_dp"] > dp_rows(B):
            qb, qe, rb, re, score = self._extend_uncompacted(enc, lens, out)
        self._count(seeds_at_cap=out["seeds_full"][:B].sum(),
                    occ_clipped=out["occ_clip"][:B].sum(),
                    chains_at_cap=(out["n_seg"][:B] > MAX_CHAINS).sum(),
                    escapees_deferred=out["esc_over"][:B].sum())
        regions: list[list[AlnReg]] = [[] for _ in range(B)]
        for b, c in zip(*np.nonzero(keep)):
            regions[b].append(AlnReg(
                int(rb[b, c]), int(re[b, c]), int(qb[b, c]),
                int(qe[b, c]), int(score[b, c]), int(weight[b, c]),
                float(frac_reps[b])))
        if dedup:
            for b in range(B):
                regions[b] = self._dedup_and_mark(regions[b])
        return regions

    def _extend_uncompacted(self, enc, lens, out):
        """Extend every kept chain in one standalone call (no DP-row
        cap): the same arithmetic as the fused path's extension."""
        keep = out["keep"]
        bs, cs = np.nonzero(keep)
        n = bs.size
        qb, qe = out["qb"].copy(), out["qe"].copy()
        rb, re = out["rb"].copy(), out["re"].copy()
        score = out["score"].copy()
        if not n:
            return qb, qe, rb, re, score
        M = _bucket(n)
        b_idx = np.full(M, -1, np.int32)
        aq = np.zeros(M, np.int32)
        alen = np.zeros(M, np.int32)
        ar = np.zeros(M, np.int64)
        b_idx[:n] = bs
        aq[:n] = out["anchor_q"][bs, cs]
        alen[:n] = out["anchor_len"][bs, cs]
        ar[:n] = out["anchor_r"][bs, cs]
        dev = self.device
        opt = self.options
        res = extend_chains(
            self.text_t, torch.from_numpy(enc).to(dev),
            torch.from_numpy(lens.astype(np.int64)).to(dev),
            *(torch.from_numpy(a).to(dev) for a in (b_idx, aq, alen, ar)),
            l_pac=self.index.l_pac, o_del=opt.o_del, e_del=opt.e_del,
            o_ins=opt.o_ins, e_ins=opt.e_ins, match=opt.a, mismatch=opt.b,
            pen_clip5=opt.pen_clip5, pen_clip3=opt.pen_clip3, w=opt.w,
            zdrop=opt.zdrop)
        eqb, eqe, erb, ere, esc = (r.cpu().numpy() for r in res)
        qb[bs, cs] = eqb[:n]
        qe[bs, cs] = eqe[:n]
        rb[bs, cs] = erb[:n]
        re[bs, cs] = ere[:n]
        score[bs, cs] = esc[:n]
        return qb, qe, rb, re, score

    # ------------------------------------------------------------------
    # long-read path (> self.LONG_READ_BP): device seeding, host chaining
    # ------------------------------------------------------------------

    def _collect_regions_long(self, enc: np.ndarray, lens: np.ndarray
                              ) -> list[list[AlnReg]]:
        """Regions of reads beyond the fused path's 1024 bp chain keys:
        seeding and SA locate on the device (K2), host chaining (int64
        numpy, no length caps), then the banded extension (K1) of every
        kept chain; deduped and primary-marked per read."""
        opt = self.options
        B, L = enc.shape
        dev = self.device
        reads_t = torch.from_numpy(enc).to(dev)
        lens_t = torch.from_numpy(lens.astype(np.int64)).to(dev)
        # more seed slots: a multi-kb read emits about one SMEM per error
        s1 = seed_and_locate(
            self.fm, reads_t, lens_t, max_seeds=max(64, min(256, L // 32)),
            min_seed_len=opt.min_seed_len, max_occ=opt.max_occ,
            k_occ=MAX_OCC_LOCATE, split_len=opt.split_len,
            split_width=opt.split_width, max_mem_intv=opt.max_mem_intv)
        pos = s1["pos"].cpu().numpy().astype(np.int64)
        Bv, S1, K = pos.shape
        l_pac = self.index.l_pac
        rid = np.repeat(np.arange(Bv, dtype=np.int32), S1 * K)
        oqb = np.repeat(s1["qbeg"].cpu().numpy().astype(np.int64), K, axis=1)
        oqe = np.repeat(s1["qend"].cpu().numpy().astype(np.int64), K, axis=1)
        oqb, oqe, op = oqb.reshape(-1), oqe.reshape(-1), pos.reshape(-1)
        val = (op >= 0) & ~((op < l_pac) & (op + oqe - oqb > l_pac))
        ch = chain_batch(rid[val], oqb[val], oqe[val], op[val], l_pac=l_pac,
                         band=opt.w, max_chain_gap=opt.max_chain_gap,
                         drop_ratio=opt.drop_ratio, max_chains=MAX_CHAINS)
        n = ch["read"].size
        regions: list[list[AlnReg]] = [[] for _ in range(B)]
        if not n:
            return regions
        # one extension lane per chain (lanes are independent)
        res = extend_chains(
            self.text_t, reads_t, lens_t,
            *(torch.from_numpy(ch[k].astype(np.int64)).to(dev)
              for k in ("read", "anchor_q", "anchor_len", "anchor_r")),
            l_pac=l_pac, o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
            e_ins=opt.e_ins, match=opt.a, mismatch=opt.b,
            pen_clip5=opt.pen_clip5, pen_clip3=opt.pen_clip3, w=opt.w,
            zdrop=opt.zdrop)
        eqb, eqe, erb, ere, esc = (r.cpu().numpy() for r in res)
        frac_reps = s1["rep_cov"].cpu().numpy() / np.maximum(lens, 1)
        for k in range(n):
            b = int(ch["read"][k])
            regions[b].append(AlnReg(
                int(erb[k]), int(ere[k]), int(eqb[k]), int(eqe[k]),
                int(esc[k]), int(ch["weight"][k]), float(frac_reps[b])))
        return [self._dedup_and_mark(rs) for rs in regions]

    def _align_batch_long(self, seqs, names, hardclip, keep_sec_frac,
                          max_secondary):
        enc, lens = self._encode_batch(seqs)
        B = len(seqs)
        regions = self._collect_regions_long(enc, lens)[:B]
        if keep_sec_frac < 0.0 or keep_sec_frac > 1.0:
            regions = [[r for r in rs if r.secondary < 0] for rs in regions]
        hits = self._cols_to_hit_dicts(
            self._regions_to_hits(enc, lens, regions), B)
        return [self._assemble_records(seqs[b], names[b], hits[b], hardclip,
                                       keep_sec_frac, max_secondary)
                for b in range(B)]

    def _dedup_and_mark(self, regs: list[AlnReg], key=None) -> list[AlnReg]:
        """mem_sort_dedup + mem_mark_primary_se semantics.  ``key(r) ->
        (kb, ke)`` is the reference interval of the overlap tests: the
        region's own (rb, re) by default, global pseudo-2L keys on a
        sharded index."""
        opt = self.options
        if key is None:
            def key(r):
                return r.rb, r.re
        # dedup near-identical regions, walking (-score, kb, qb, ke)
        regs = sorted(regs, key=lambda r: (-r.score, key(r)[0], r.qb,
                                           key(r)[1]))
        out: list[AlnReg] = []
        for r in regs:
            dup = False
            krb, kre = key(r)
            for o in out:
                okb, oke = key(o)
                if max(krb, okb) < min(kre, oke):
                    inter = min(kre, oke) - max(krb, okb)
                    minw = min(kre - krb, oke - okb)
                    if inter >= opt.mask_level_redun * minw \
                            and max(r.qb, o.qb) < min(r.qe, o.qe):
                        dup = True
                        break
            if not dup:
                out.append(r)
        # bwa's mem_mark_primary_se walk: score desc, equal scores broken
        # by hash_64(i), i = the region's index in the post-dedup list
        ranked = sorted(enumerate(out),
                        key=lambda t: (-t[1].score, _hash64(t[0])))
        out = [r for _, r in ranked]
        # primary/secondary by query overlap; sub_n counts losers within
        # max(a+b, o_del+e_del, o_ins+e_ins) of the primary
        tmp = max(opt.a + opt.b, opt.o_del + opt.e_del,
                  opt.o_ins + opt.e_ins)
        kept: list[int] = []
        for i, r in enumerate(out):
            placed = False
            for k in kept:
                p = out[k]
                bmax, emin = max(r.qb, p.qb), min(r.qe, p.qe)
                if emin > bmax:
                    minl = min(r.qe - r.qb, p.qe - p.qb)
                    if emin - bmax >= opt.mask_level * minl:
                        r.secondary = k
                        if p.sub == 0:
                            p.sub = r.score
                        if p.score - r.score <= tmp:
                            p.sub_n += 1
                        placed = True
                        break
            if not placed:
                kept.append(i)
        if len(out) > MAX_REGS:
            self._count(regs_truncated=1)
        return out[:MAX_REGS]

    def _in_wide_window(self, Lq: int, qspan, tspan):
        """The wide window's rule: a region whose query span passes the
        read width, or whose target span the wide window (``dp_widths``),
        is dropped, and counted in ``regions_dropped_wide``."""
        ok = (qspan <= Lq) & (tspan <= dp_widths(Lq, self.options.w)[1])
        self._count(regions_dropped_wide=(~ok).sum())
        return ok

    def _regions_to_hits(self, enc, lens, regions):
        """Columnar hits (``_host_cols``' format) of per-read region
        lists: every region with score >= T inside the wide window, in
        its read's list order (``slot`` its index there).  An exact match
        (score = span * a, equal spans, equal bases) is one M run with NM
        0; the others go through the host global DP, in the narrow
        window (split over a mesh) or the wide one."""
        opt = self.options
        flat = [(b, k, r) for b, rs in enumerate(regions)
                for k, r in enumerate(rs) if r.score >= opt.T]
        read = np.array([b for b, _, _ in flat], np.int64)
        slot = np.array([k for _, k, _ in flat], np.int64)
        f = np.array([(r.qb, r.qe, r.rb, r.re, r.score, r.sub, r.sub_n,
                       r.secondary) for _, _, r in flat],
                     np.int64).reshape(-1, F_SEC + 1)
        frac_rep = np.array([r.frac_rep for _, _, r in flat], np.float64)
        Lq = enc.shape[1]
        Lt, Lt_wide = dp_widths(Lq, opt.w)
        qspan, tspan = f[:, F_QE] - f[:, F_QB], f[:, F_RE] - f[:, F_RB]
        ok = self._in_wide_window(Lq, qspan, tspan)
        self._count(regions_widened=(ok & (tspan > Lt)).sum())
        read, slot, f, frac_rep, qspan, tspan = (
            x[ok] for x in (read, slot, f, frac_rep, qspan, tspan))
        rows = np.column_stack([read, f[:, F_QB:F_RE + 1]])
        cand = np.flatnonzero((f[:, F_SCORE] == qspan * opt.a)
                              & (tspan == qspan))
        perfect = np.zeros(read.size, bool)
        perfect[cand] = (
            _windows(enc.reshape(-1), read[cand] * Lq + f[cand, F_QB],
                     qspan[cand], Lq)
            == _windows(self.text, f[cand, F_RB], tspan[cand], Lq)).all(1)
        nm = np.zeros(read.size, np.int32)
        cig_off = np.zeros(read.size, np.int64)
        cig_n = np.zeros(read.size, np.int32)
        words = [np.zeros(0, np.int32)]
        for sel, width, band, split in (
                (~perfect & (tspan <= Lt), Lt, 2 * opt.w + 8, True),
                (~perfect & (tspan > Lt), Lt_wide, Lt_wide + 8, False)):
            idx = np.flatnonzero(sel)
            nm[idx], off, cig_n[idx], w = self._window_dp(
                enc, rows[idx], width, band, split)
            cig_off[idx] = off + sum(x.size for x in words)
            words.append(w)
        n_regs = np.array([len(rs) for rs in regions], np.int64)
        return self._hit_cols(
            lens, read, slot, f, frac_rep, n_regs[read], nm, cig_off, cig_n,
            np.where(perfect, qspan, 0), *_split_runs(np.concatenate(words)))

    def _window_dp(self, enc, rows, width: int, band: int,
                   split: bool = False):
        """The host global DP of region windows: ``rows`` int64 [M, 5] of
        (read, qb, qe, rb, re) -> each row's NM (int32 [M]), first run
        (int64 [M]) and run count (int32 [M]) in the run words it returns
        (``global_and_traceback``'s, int32).  Query windows are the read's
        width, target windows ``width`` codes.  With ``split`` on a mesh
        the rows are cut into one contiguous piece per entry, each run on
        the entry's device at once (rows are independent)."""
        M = rows.shape[0]
        if not M:
            return (np.zeros(0, np.int32), np.zeros(0, np.int64),
                    np.zeros(0, np.int32), np.zeros(0, np.int32))
        b, qb, qe, rb, re = rows.T
        Lq = enc.shape[1]
        args = (_windows(enc.reshape(-1), b * Lq + qb, qe - qb, Lq),
                (qe - qb).astype(np.int32),
                _windows(self.text, rb, re - rb, width),
                (re - rb).astype(np.int32))
        opt = self.options
        kw = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                  e_ins=opt.e_ins, match=opt.a, mismatch=opt.b, band=band)

        def run(sel, dev):
            _, nm, run_off, runs = global_and_traceback(
                *(torch.from_numpy(a[sel]).to(dev) for a in args), **kw)
            return (nm.cpu().numpy(), *_fetch_runs(run_off, runs))

        if not split or self.mesh is None:
            outs = [run(slice(None), self.device)]
        else:
            pieces = np.array_split(np.arange(M), self.n_shards)
            groups = [(d, [lambda r=r, d=d: run(r, d)])
                      for r, d in zip(pieces, self.mesh.devices) if r.size]
            outs = [g[0] for g in run_on_devices(groups)]
        base = np.cumsum([0] + [o[2].size for o in outs[:-1]])
        return (np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1][:-1] + k for o, k in zip(outs, base)]),
                np.concatenate([np.diff(o[1]) for o in outs]).astype(np.int32),
                np.concatenate([o[2] for o in outs]))

    # ------------------------------------------------------------------
    # host: MAPQ, contig resolution, columnar hits
    # ------------------------------------------------------------------

    def _hits_cols_from_full(self, enc, lens, res):
        """Columnar hits (grouped by read, aligner append order) from the
        device program's outputs, ready for ``native.bam_encode_hits``;
        a mesh's slices are merged (``_merge_cols``).  Returns None (and
        counts ``fused_overflow_fallback`` once) when the extension DP
        rows of the batch, or of any slice, overflowed: the caller reruns
        the batch through the classic path."""
        if not isinstance(res, _Slices):
            cols = self._slice_cols(enc, lens, res)
        else:
            b = enc.shape[0] // len(res)
            parts = [self._slice_cols(enc[k * b:(k + 1) * b],
                                      lens[k * b:(k + 1) * b], r)
                     for k, r in enumerate(res)]
            cols = None if any(c is None for c in parts) \
                else _merge_cols(parts, b)
        if cols is None:
            self._count(fused_overflow_fallback=1)
        return cols

    def _slice_cols(self, enc, lens, res):
        """``_hits_cols_from_full`` of one device program's outputs, None
        on an overflow."""
        with profiling.span("finish.fetch"):
            regions, snm = (r.cpu().numpy() for r in res[:2])
            run_off, runs = _fetch_runs(*res[2:])
        with profiling.span("finish.cols"):
            return self._host_cols(enc, lens, regions, snm, run_off, runs)

    def _host_cols(self, enc, lens, regions, snm, run_off, runs):
        """``_slice_cols`` on the outputs fetched to the host: the hits of
        the device's global-DP rows and exact matches, then, after their
        read's other hits, the wide and overflowed regions (FLAG_WIDE,
        FLAG_OVER) through the host global DP in the wide window.  A DP
        row d's runs are ``runs[run_off[d]:run_off[d + 1]]``."""
        opt = self.options
        B, Lq = enc.shape
        C = REGION_SLOTS
        fields = regions[:, :C * NFIELD].reshape(B, C, NFIELD) \
            .astype(np.int64)
        extra0 = C * NFIELD
        rep_cov = regions[:, extra0]
        n_regs = regions[:, extra0 + 1]
        self._count(occ_clipped=regions[:, extra0 + 2].sum(),
                    seeds_at_cap=regions[:, extra0 + 3].sum(),
                    chains_at_cap=(regions[:, extra0 + 4] > MAX_CHAINS).sum(),
                    escapees_deferred=regions[:, extra0 + 7].sum())
        if B and int(regions[0, extra0 + 6]) > dp_rows(B):
            return None

        flags = fields[:, :, F_FLAGS]
        emit = ((flags & FLAG_EMIT) != 0) & (fields[:, :, F_SCORE] >= opt.T)
        dprow = fields[:, :, F_DPROW]
        perfect = (flags & FLAG_PERFECT) != 0
        b_m, j_m = np.nonzero(emit & ((dprow >= 0) | perfect))
        perf_m = perfect[b_m, j_m]
        d_m = np.where(perf_m, 0, dprow[b_m, j_m])
        off_m = run_off[d_m]
        cnt_m = run_off[d_m + 1] - off_m
        nm_m = np.where(perf_m, 0, snm[d_m, 1])
        mlen_m = np.where(perf_m, fields[b_m, j_m, F_QE]
                          - fields[b_m, j_m, F_QB], 0)

        fb = emit & ((flags & (FLAG_WIDE | FLAG_OVER)) != 0)
        self._count(regions_widened=(fb & ((flags & FLAG_WIDE) != 0)).sum())
        b_f, j_f = np.nonzero(fb)
        f_f = fields[b_f, j_f]
        ok = self._in_wide_window(Lq, f_f[:, F_QE] - f_f[:, F_QB],
                                  f_f[:, F_RE] - f_f[:, F_RB])
        b_f, j_f, f_f = b_f[ok], j_f[ok], f_f[ok]
        Lt_wide = dp_widths(Lq, opt.w)[1]
        nm_f, off_f, cnt_f, words_f = self._window_dp(
            enc, np.column_stack([b_f, f_f[:, F_QB:F_RE + 1]]), Lt_wide,
            Lt_wide + 8)

        b = np.concatenate([b_m, b_f])
        j = np.concatenate([j_m, j_f])
        frac_rep = rep_cov.astype(np.float64) / np.maximum(lens, 1)[:B]
        return self._hit_cols(
            lens, b, j, fields[b, j], frac_rep[b], n_regs[b],
            np.concatenate([nm_m, nm_f]),
            np.concatenate([np.where(perf_m, 0, off_m), off_f + runs.size]),
            np.concatenate([np.where(perf_m, 0, cnt_m), cnt_f]),
            np.concatenate([mlen_m, np.zeros(b_f.size, np.int64)]),
            *_split_runs(np.concatenate([runs, words_f])))

    def _hit_cols(self, lens, read, slot, f, frac_rep, n_regs, nm, cig_off,
                  cig_n, match_len, run_ops, run_lens):
        """Per-hit arrays -> the columnar hits ``native.bam_encode_hits``
        takes: each hit's contig, position and clips (a region across a
        contig's end is dropped) and its MAPQ (0 for a secondary), grouped
        by read, in the given order within a read.  ``f`` holds each
        hit's region fields F_QB..F_SEC (``device_full``'s layout);
        ``cig_off``/``cig_n`` index ``run_ops``/``run_lens``, and a hit
        with no runs is one M run of ``match_len``."""
        qb, qe = f[:, F_QB], f[:, F_QE]
        rb, re = f[:, F_RB], f[:, F_RE]
        score, sec = f[:, F_SCORE], f[:, F_SEC]
        l_pac = self.index.l_pac
        is_rev = rb >= l_pac
        L = lens[read].astype(np.int64)
        pos2l = np.where(is_rev, 2 * l_pac - re, rb)
        rid = np.searchsorted(self._ann_offs, pos2l, side="right") - 1
        pos = pos2l - self._ann_offs[rid]
        mapq = np.where(sec >= 0, 0, approx_mapq(
            self.options, score, f[:, F_SUB], f[:, F_SUBN],
            np.maximum(qe - qb, re - rb), frac_rep))
        keep = np.flatnonzero(pos + (re - rb) <= self._ann_lens[rid])
        o = keep[np.argsort(read[keep], kind="stable")]
        return dict(
            read_idx=read[o].astype(np.int32),
            rid=rid[o].astype(np.int32),
            pos=pos[o].astype(np.int32),
            is_rev=is_rev[o].astype(np.uint8),
            is_sec=(sec[o] >= 0).astype(np.uint8),
            score=score[o].astype(np.int32),
            mapq=mapq[o].astype(np.int32),
            nm=nm[o].astype(np.int32),
            n_regs=n_regs[o].astype(np.int32),
            slot=slot[o].astype(np.int32),
            sec=sec[o].astype(np.int32),
            clip5=np.where(is_rev, L - qe, qb)[o].astype(np.int32),
            clip3=np.where(is_rev, qb, L - qe)[o].astype(np.int32),
            cig_off=cig_off[o].astype(np.int64),
            cig_n=cig_n[o].astype(np.int32),
            match_len=match_len[o].astype(np.int32),
            run_ops=np.ascontiguousarray(run_ops, np.uint8),
            run_lens=np.ascontiguousarray(run_lens, np.int32))

    # ------------------------------------------------------------------
    # native record emission
    # ------------------------------------------------------------------

    def _ref_name_arrays(self):
        """Contig-name blob + offsets for the native XA/SAM encoder."""
        if self._ref_blob_cache is None:
            enc_names = [n.encode() for n in self._names]
            off = np.zeros(len(enc_names) + 1, np.int64)
            np.cumsum(np.array([len(b) for b in enc_names], np.int64),
                      out=off[1:])
            blob = np.frombuffer(b"".join(enc_names), np.uint8)
            self._ref_blob_cache = (blob, off)
        return self._ref_blob_cache

    def _payload_batch(self, chunk, enc, lens, res, hardclip,
                       keep_sec_frac, max_secondary, sam=False):
        """Device outputs -> serialized BAM records (or SAM text) and
        per-read record counts, through native/bamenc.cpp; a batch that
        overflowed the fused program's DP rows goes through the object
        path (classic rerun, BamRecord serialisation) instead."""
        B = len(chunk)
        cols = self._hits_cols_from_full(enc, lens, res)
        if cols is None:
            hdr = self.index.header_from_index() if sam else None
            payload = bytearray()
            counts = np.zeros(B, np.int32)
            for b, (_, recs) in enumerate(self._finish_batch(
                    chunk, enc, lens, res, hardclip, keep_sec_frac,
                    max_secondary)):
                counts[b] = len(recs)
                for r in recs:
                    if sam:
                        payload += r.to_sam(hdr).encode() + b"\n"
                    else:
                        payload += encode_record(r)
            return bytes(payload), counts
        mask = cols["read_idx"] < B
        if not mask.all():
            cols = _take_cols(cols, mask)
        opt = self.options
        ksf = keep_sec_frac
        if keep_sec_frac < 0.0 or keep_sec_frac > 1.0:
            cols = _take_cols(cols, cols["is_sec"] == 0)
            ksf = 0.0
        qn = [r.name.encode() for r in chunk]
        sq = [r.seq.encode() for r in chunk]
        qname_off = np.zeros(B + 1, np.int64)
        np.cumsum(np.array([len(x) for x in qn], np.int64),
                  out=qname_off[1:])
        seq_off = np.zeros(B + 1, np.int64)
        np.cumsum(np.array([len(x) for x in sq], np.int64), out=seq_off[1:])
        ref_blob, ref_off = self._ref_name_arrays()
        with profiling.span("finish.encode"):
            return _native.bam_encode_hits(
                cols, np.frombuffer(b"".join(qn), np.uint8), qname_off,
                np.frombuffer(b"".join(sq), np.uint8), seq_off,
                ref_blob, ref_off, hardclip, ksf, max_secondary,
                opt.XA_drop_ratio, opt.max_XA_hits, mode=1 if sam else 0)

    def align_batch_bam(self, seqs: list[str], names: list[str],
                        hardclip: bool = False, keep_sec_frac: float = 0.9,
                        max_secondary: int = 10, sam: bool = False):
        """Align a batch; returns (payload, counts): the serialized BAM
        records (or SAM text lines with ``sam=True``) and the number of
        records emitted per read."""
        _Read = collections.namedtuple("_Read", "name seq")
        B = len(seqs)
        if B == 0:
            return b"", np.zeros(0, np.int32)
        chunk = [_Read(n, s) for n, s in zip(names, seqs)]
        enc, lens = self._encode_batch(seqs)
        res = self._dispatch_full(enc, lens)
        return self._payload_batch(chunk, enc, lens, res, hardclip,
                                   keep_sec_frac, max_secondary, sam)

    def _stream(self, read_iter, batch_size: int, workers: int, finish):
        """Batches of ``batch_size`` reads: each dispatched to the device
        in turn, ``finish(chunk, enc, lens, res)`` on a small thread pool
        while the next batch runs; yields finish's results in order.

        Spans while tracing is on (``profiling``): on this thread one
        ``stream.batch`` a batch, holding ``stream.read`` (pulling its
        reads), ``stream.encode``, ``align.full`` (the device program's
        dispatch), and ``stream.wait`` (blocked on an older batch's
        finish) and ``stream.caller`` (suspended at a yield) for the
        batches it hands over; the last batches' waits and yields after
        the reads run out are spans of their own.  On a worker,
        ``stream.finish`` with the batch's id."""

        def finish_batch(bid, chunk, enc, lens, res):
            with profiling.span("stream.finish", batch=bid):
                out = finish(chunk, enc, lens, res)
                profiling.device_times(bid)
            return out

        def hand_over(fut, bid=None):
            with profiling.span("stream.wait", batch=bid):
                out = fut.result()
            with profiling.span("stream.caller", batch=bid):
                yield out

        reads = iter(read_iter)
        end = object()
        with _fut.ThreadPoolExecutor(max(workers, 1)) as pool:
            inflight: list = []
            while (first := next(reads, end)) is not end:
                bid = profiling.new_batch()
                with profiling.span("stream.batch", batch=bid):
                    with profiling.span("stream.read"):
                        chunk = [first, *itertools.islice(reads,
                                                          batch_size - 1)]
                    with profiling.span("stream.encode"):
                        enc, lens = self._encode_batch([r.seq for r in chunk])
                    with profiling.span("align.full", device=self.device):
                        res = self._dispatch_full(enc, lens)
                    inflight.append((bid, pool.submit(
                        finish_batch, bid, chunk, enc, lens, res)))
                    while len(inflight) >= max(workers, 1) + 1:
                        yield from hand_over(inflight.pop(0)[1])
            for bid, fut in inflight:
                yield from hand_over(fut, bid)

    def align_stream_bam(self, read_iter, batch_size: int = 4096,
                         hardclip: bool = False, keep_sec_frac: float = 0.9,
                         max_secondary: int = 10, workers: int = 2,
                         sam: bool = False):
        """Streaming alignment: yields (chunk, payload, counts) per batch
        of ``batch_size`` reads (objects with ``.name`` and ``.seq``), in
        order.  Host record emission of one batch runs on a small
        thread pool while the next batch runs on the device."""

        def finish(chunk, enc, lens, res):
            payload, counts = self._payload_batch(
                chunk, enc, lens, res, hardclip, keep_sec_frac,
                max_secondary, sam)
            return chunk, payload, counts

        yield from self._stream(read_iter, batch_size, workers, finish)

    def align_stream(self, read_iter, batch_size: int = 4096,
                     hardclip: bool = False, keep_sec_frac: float = 0.9,
                     max_secondary: int = 10, workers: int = 2):
        """Streaming alignment: yields (read, records) for each read of
        ``read_iter`` (objects with ``.name`` and ``.seq``), in input
        order, the records as ``align_batch`` gives them.  Each batch's
        records are built on a small thread pool while the next batch
        runs on the device."""

        def finish(chunk, enc, lens, res):
            return list(self._finish_batch(chunk, enc, lens, res, hardclip,
                                           keep_sec_frac, max_secondary))

        for pairs in self._stream(read_iter, batch_size, workers, finish):
            yield from pairs

    # ------------------------------------------------------------------
    # object API: BamRecord lists
    # ------------------------------------------------------------------

    def _hits_from_full(self, enc, lens, res):
        """Per-read hit dicts from the device program's outputs, or from
        the classic path when its extension DP rows overflowed."""
        cols = self._hits_cols_from_full(enc, lens, res)
        if cols is None:
            cols = self._regions_to_hits(enc, lens,
                                         self._collect_regions(enc, lens))
        return self._cols_to_hit_dicts(cols, enc.shape[0])

    def _cols_to_hit_dicts(self, cols, B):
        """Columnar hits -> per-read dict lists, the shape
        ``_assemble_records`` takes (the only maker of dict hits)."""
        hits: list[list[dict]] = [[] for _ in range(B)]
        ro, rl = cols["run_ops"], cols["run_lens"]
        ri = cols["read_idx"]
        for i in range(ri.size):
            n = int(cols["cig_n"][i])
            if n == 0:
                cig2l = [("M", int(cols["match_len"][i]))]
            else:
                o = int(cols["cig_off"][i])
                cig2l = [("MDI"[ro[k]], int(rl[k])) for k in range(o, o + n)]
            if cols["is_rev"][i]:
                cig2l = list(reversed(cig2l))
            c5, c3 = int(cols["clip5"][i]), int(cols["clip3"][i])
            full = ([("N", c5)] if c5 else []) + cig2l \
                + ([("N", c3)] if c3 else [])
            hits[int(ri[i])].append(dict(
                rid=int(cols["rid"][i]), pos=int(cols["pos"][i]),
                is_rev=bool(cols["is_rev"][i]),
                score=int(cols["score"][i]), mapq=int(cols["mapq"][i]),
                secondary=bool(cols["is_sec"][i]), cigar=full,
                nm=int(cols["nm"][i]), n_regs=int(cols["n_regs"][i]),
                slot=int(cols["slot"][i]), sec=int(cols["sec"][i])))
        return hits

    def _finish_batch(self, chunk, enc, lens, res, hardclip,
                      keep_sec_frac, max_secondary):
        """Yields (read, records) for each read of ``chunk``."""
        hits = self._hits_from_full(enc, lens, res)
        if keep_sec_frac < 0.0 or keep_sec_frac > 1.0:
            hits = [[h for h in hs if not h["secondary"]] for hs in hits]
        for b, r in enumerate(chunk):
            yield r, self._assemble_records(r.seq, r.name, hits[b], hardclip,
                                            keep_sec_frac, max_secondary)

    def align_batch(self, seqs: list[str], names: list[str],
                    hardclip: bool = False, keep_sec_frac: float = 0.9,
                    max_secondary: int = 10) -> list[list[BamRecord]]:
        """Align a batch of reads; returns per-read BamRecord lists (MAPQ
        sort, keepSecFrac/maxSecondary filters, clip rewrite, XA).  A
        batch with a read over ``self.LONG_READ_BP`` takes the long-read
        path."""
        if not seqs:
            return []
        if max(len(s) for s in seqs) > self.LONG_READ_BP:
            return self._align_batch_long(seqs, names, hardclip,
                                          keep_sec_frac, max_secondary)
        _Read = collections.namedtuple("_Read", "name seq")
        chunk = [_Read(n, s) for n, s in zip(names, seqs)]
        enc, lens = self._encode_batch(seqs)
        res = self._dispatch_full(enc, lens)
        return [recs for _, recs in self._finish_batch(
            chunk, enc, lens, res, hardclip, keep_sec_frac, max_secondary)]

    def align_sequence(self, seq, name: str = "", out: list | None = None,
                       hardclip: bool = False, keep_sec_frac: float = 0.9,
                       max_secondary: int = 10) -> list[BamRecord]:
        """One read (a string or an UnalignedSequence) -> its records,
        also appended to ``out`` when given.  With ``set_copy_comment``
        an UnalignedSequence's comment becomes a BC tag."""
        if isinstance(seq, UnalignedSequence):
            recs = self.align_sequence(seq.seq, seq.name, None, hardclip,
                                       keep_sec_frac, max_secondary)
            if self._copy_comment:
                for r in recs:
                    r.add_z_tag("BC", seq.com)
        else:
            recs = self.align_batch([seq], [name], hardclip, keep_sec_frac,
                                    max_secondary)[0]
        if out is not None:
            out.extend(recs)
        return recs

    def _assemble_records(self, seq: str, name: str, hits: list[dict],
                          hardclip: bool, keep_sec_frac: float,
                          max_secondary: int) -> list[BamRecord]:
        """One read's hits -> records, with bwa mem's XA: each secondary
        whose score >= XA_drop_ratio * its primary's becomes a
        "ref,(+-)pos1,cigar,NM;" entry on that primary (none when more
        than max_XA_hits qualify), gathered before the keepSecFrac /
        maxSecondary filters."""
        opt = self.options
        xa_of: dict[int, list[str]] = {}
        if hits:
            by_slot = {h["slot"]: h for h in hits if h.get("slot", -1) >= 0}
            for h in hits:
                r = h.get("sec", -1)
                if r < 0:
                    continue
                p = by_slot.get(r)
                if p is None or h["score"] < p["score"] * opt.XA_drop_ratio:
                    continue
                cig = "".join(f"{ln}{'S' if op == 'N' else op}"
                              for op, ln in h["cigar"])
                xa_of.setdefault(r, []).append(
                    f"{self._names[h['rid']]},"
                    f"{'-' if h['is_rev'] else '+'}{h['pos'] + 1},"
                    f"{cig},{h['nm']};")
        # sort: MAPQ desc, then rid, then pos
        hits = sorted(hits, key=lambda h: (-h["mapq"], h["rid"], h["pos"]))
        out: list[BamRecord] = []
        primary_score = 0.0
        clip_op = "H" if hardclip else "S"
        for i, h in enumerate(hits):
            is_sec = h["secondary"]
            too_low = is_sec and (primary_score * keep_sec_frac > h["score"])
            too_many = is_sec and (i > max_secondary)
            if too_low or too_many:
                continue
            if not is_sec:
                primary_score = h["score"]
            rec = BamRecord()
            rec.qname = name
            rec.tid = h["rid"]
            rec.pos = h["pos"]
            rec.mapq = h["mapq"]
            rec.flag = (FSECONDARY if is_sec else 0) \
                | (FREVERSE if h["is_rev"] else 0)
            # clips are N placeholders: S, or H with the sequence trimmed
            clipped = seq
            if hardclip:
                tstart = 0
                clen = 0
                for k, (op, ln) in enumerate(h["cigar"]):
                    if k == 0 and op == "N":
                        tstart = ln
                    elif op in ("M", "I", "S", "=", "X"):
                        clen += ln
                clipped = seq[tstart:tstart + clen] if clen else seq
            rec.cigar = Cigar([CigarField(clip_op if op == "N" else op, ln)
                               for op, ln in h["cigar"]])
            rec.seq = revcomp(clipped) if h["is_rev"] else clipped.upper()
            rec.qual = None
            rec.add_int_tag("NA", h["n_regs"])
            rec.add_int_tag("NM", h["nm"])
            xa = xa_of.get(h.get("slot", -1))
            if xa and not is_sec and len(xa) <= opt.max_XA_hits:
                rec.add_z_tag("XA", "".join(xa))
            rec.add_int_tag("AS", h["score"])
            out.append(rec)
        return out
