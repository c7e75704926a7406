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
"""

from __future__ import annotations

import collections
import concurrent.futures as _fut
import math
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import native as _native
from ..core.cigar import Cigar, CigarField
from ..core.record import FREVERSE, FSECONDARY, BamRecord
from ..core.seq import NT4_TABLE, revcomp
from ..core.unaligned import UnalignedSequence
from ..device import resolve_device
from ..index.pack import both_strands
from ..io.bam import encode_record
from ..ops.fm import DeviceFMIndex
from .device_full import (FLAG_EMIT, FLAG_OVER, FLAG_PERFECT, FLAG_WIDE,
                          NFIELD, _hash64, align_full)
from .chain import chain_batch
from .device_pipeline import (ESC_SLOTS, dp_rows, extend_chains,
                              global_and_traceback_packed, seed_and_locate,
                              seed_chain_extend)
from .options import AlignerOptions

MAX_SEEDS = 16          # per read from the seed scan
MAX_OCC_LOCATE = 16     # occurrences located per seed
MAX_CHAINS = 4          # chains extended per read
REGION_SLOTS = MAX_CHAINS + ESC_SLOTS
MAX_REGS = 8            # alignment regions kept per read (classic path)
# the global DP's direction matrix is M x Lq x (Lt + 1) bytes: regions go
# through it in groups of at most this many bytes (rows are independent)
GLOBAL_DP_BYTES = 4 << 30


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


def _unpack_ops(packed: np.ndarray) -> np.ndarray:
    """Inverse of the device 2-bit packing -> [M, 4*Tp] step codes."""
    p = packed.astype(np.uint8)
    M, Tp = p.shape
    out = np.empty((M, Tp * 4), np.uint8)
    out[:, 0::4] = p & 3
    out[:, 1::4] = (p >> 2) & 3
    out[:, 2::4] = (p >> 4) & 3
    out[:, 3::4] = (p >> 6) & 3
    return out


def _ops_to_cigars_batch(ops: np.ndarray, n_rows: int
                         ) -> list[list[tuple[str, int]]]:
    """Run-length decode traceback codes (reverse walk order, OP_NONE = 3
    padding) into per-row CIGAR lists in forward 2L order."""
    out: list[list[tuple[str, int]]] = [[] for _ in range(n_rows)]
    for r, o, ln in zip(*(a.tolist() for a in _ops_to_runs(ops, n_rows))):
        out[r].append(("MDI"[o], ln))
    return out


def _ops_to_runs(ops: np.ndarray, n_rows: int):
    """Run-length decode traceback codes into (run_rows, run_ops,
    run_lens), rows ascending, runs in forward 2L order (0=M 1=D 2=I)."""
    sub = ops[:n_rows, ::-1]
    rows, cols = np.nonzero(sub < 3)
    vals = sub[rows, cols]
    if vals.size == 0:
        return (np.empty(0, np.int32), np.empty(0, np.uint8),
                np.empty(0, np.int32))
    brk = np.ones(vals.size, dtype=bool)
    brk[1:] = (rows[1:] != rows[:-1]) | (vals[1:] != vals[:-1])
    starts = np.flatnonzero(brk)
    lens = np.diff(np.append(starts, vals.size))
    return (rows[starts].astype(np.int32),
            vals[starts].astype(np.uint8), lens.astype(np.int32))


def _filter_cols(cols: dict, mask: np.ndarray) -> dict:
    """Keep only hits selected by ``mask`` (run arrays stay shared)."""
    out = dict(cols)
    for k, v in cols.items():
        if k not in ("run_ops", "run_lens"):
            out[k] = v[mask]
    return out


class BWAAligner:
    """Single-end aligner over an :class:`~seqlib_tpu_torch.index.FMIndex`.

    ``device`` is where the device program runs: ``"cuda"`` (default,
    the hand-written kernels) or ``"cpu"`` (their plain PyTorch
    versions).  ``wide`` picks the int64 index path: by default an index
    whose 2L text is 2^31 or more takes it, and ``wide=True`` forces it
    on any index.  Scoring options are set through the ``set_*`` methods
    (reference-style names) or ``self.options``."""

    LONG_READ_BP = 1024   # the fused path's packed chain keys cap reads here

    def __init__(self, index, options: AlignerOptions | None = None,
                 wide: bool | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.index = index
        self.options = options or AlignerOptions()
        self.wide = index.seq_len >= 2**31 if wide is None else bool(wide)
        self.text = both_strands(index.ref.codes)
        self.fm = DeviceFMIndex.from_host(index, device=self.device,
                                          wide=self.wide)
        self.text_t = torch.from_numpy(self.text).to(self.device)
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
        """Devices a batch is split over: 1 (one card)."""
        return 1

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
        Bp = _bucket(len(seqs), mn=8)
        lens = np.zeros(Bp, np.int64)
        lens[:len(seqs)] = [len(s) for s in seqs]
        enc = np.full((Bp, L), 4, np.uint8)
        codes = NT4_TABLE[np.frombuffer("".join(seqs).encode(), np.uint8)]
        enc[np.arange(L, dtype=np.int64)[None, :] < lens[:, None]] = codes
        return enc, lens

    def _dispatch_full(self, enc: np.ndarray, lens: np.ndarray):
        """Run the whole device program for one encoded batch; returns
        (regions, snm, ops) tensors on the aligner's device."""
        if int(lens.max(initial=0)) > self.LONG_READ_BP:
            raise FusedOverflowError(
                f"reads longer than {self.LONG_READ_BP} bp exceed the fused "
                "path's packed chain keys: align them with align_batch, "
                "which routes them through the long-read path")
        opt = self.options
        enc_lens = np.concatenate(
            [enc, lens.astype("<u4").view(np.uint8).reshape(-1, 4)], axis=1)
        return align_full(
            self.fm, self.text_t,
            torch.from_numpy(enc_lens).to(self.device),
            **self._stage1_kwargs(), T=opt.T, mask_level=opt.mask_level,
            mask_level_redun=opt.mask_level_redun,
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
        extension) of an encoded batch; its tensors stay on the
        aligner's device."""
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
        hits = self._regions_to_hits(enc, lens, regions)
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

    def _mapq(self, r: AlnReg) -> int:
        """bwa's mem_approx_mapq_se, float64."""
        opt = self.options
        sub = r.sub if r.sub else opt.min_seed_len * opt.a
        sub = max(sub, r.csub)
        if sub >= r.score:
            return 0
        length = max(r.qe - r.qb, r.re - r.rb)
        identity = 1.0 - float(length * opt.a - r.score) \
            / (opt.a + opt.b) / length
        if r.score == 0:
            mapq = 0
        else:
            tmp = 1.0 if length < opt.mapQ_coef_len \
                else opt.mapQ_coef_fac / math.log(length)
            tmp *= identity * identity
            mapq = int(6.02 * (r.score - sub) / opt.a * tmp * tmp + 0.499)
        if r.sub_n > 0:
            mapq -= int(4.343 * math.log(r.sub_n + 1) + 0.499)
        mapq = min(mapq, 60)
        mapq = max(mapq, 0)
        return int(mapq * (1.0 - r.frac_rep) + 0.499)

    def _regions_to_hits(self, enc, lens, regions):
        """Global-align every region with score >= T; per-read hit dicts."""
        opt = self.options
        flat = [(b, r) for b, rs in enumerate(regions) for r in rs
                if r.score >= opt.T]
        hits_per_read: list[list[dict]] = [[] for _ in range(len(regions))]
        if not flat:
            return hits_per_read
        # query bucket = read length; a narrow target bucket (deletions up
        # to 128 bp) and a wide one (up to 512 bp); longer spans are
        # dropped and counted
        Lq = enc.shape[1]
        Lt = Lq + min(2 * opt.w, 128)
        Lt_wide = Lq + 512
        kept = []
        for b, r in flat:
            span_t = r.re - r.rb
            if r.qe - r.qb <= Lq and span_t <= Lt_wide:
                kept.append((b, r))
                if span_t > Lt:
                    self._count(regions_widened=1)
            else:
                self._count(regions_dropped_wide=1)
        flat = kept
        if not flat:
            return hits_per_read
        # an exact match (score = span * a, equal spans, equal bases) is
        # one M run with NM 0 and needs no global DP
        perfect = np.zeros(len(flat), dtype=bool)
        for m, (b, r) in enumerate(flat):
            span = r.qe - r.qb
            if (r.score == span * opt.a and r.re - r.rb == span
                    and np.array_equal(enc[b, r.qb:r.qe],
                                       self.text[r.rb:r.re])):
                perfect[m] = True
        cigars: dict[int, list[tuple[str, int]]] = {}
        nms_by_row: dict[int, int] = {}
        for m in np.flatnonzero(perfect):
            b, r = flat[m]
            cigars[m] = [("M", r.qe - r.qb)]
            nms_by_row[m] = 0
        spans = np.array([r.re - r.rb for _, r in flat], np.int64)
        narrow = np.flatnonzero(~perfect & (spans <= Lt))
        wide = np.flatnonzero(~perfect & (spans > Lt))
        dev = self.device
        for rows_all, width, band in ((narrow, Lt, 2 * opt.w + 8),
                                      (wide, Lt_wide, Lt_wide + 8)):
            group = max(1, GLOBAL_DP_BYTES // (Lq * (width + 1)))
            for g in range(0, rows_all.size, group):
                dev_rows = rows_all[g:g + group]
                M = dev_rows.size
                q = np.full((M, Lq), 4, np.uint8)
                t = np.full((M, width), 4, np.uint8)
                ql = np.zeros(M, np.int32)
                tl = np.zeros(M, np.int32)
                for k, m in enumerate(dev_rows):
                    b, r = flat[m]
                    ql[k] = r.qe - r.qb
                    tl[k] = r.re - r.rb
                    q[k, :ql[k]] = enc[b, r.qb:r.qe]
                    t[k, :tl[k]] = self.text[r.rb:r.re]
                snm, packed = global_and_traceback_packed(
                    *(torch.from_numpy(a).to(dev) for a in (q, ql, t, tl)),
                    o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                    e_ins=opt.e_ins, match=opt.a, mismatch=opt.b, band=band)
                nms = snm.cpu().numpy()[:, 1]
                dev_cigs = _ops_to_cigars_batch(
                    _unpack_ops(packed.cpu().numpy()), M)
                for k, m in enumerate(dev_rows):
                    cigars[m] = dev_cigs[k]
                    nms_by_row[m] = int(nms[k])

        l_pac = self.index.l_pac
        # region-list index per read: hit['sec'] points into it (XA)
        slot_of = [{id(r): k for k, r in enumerate(rs)} for rs in regions]
        for m, (b, r) in enumerate(flat):
            is_rev = r.rb >= l_pac
            L = int(lens[b])
            if is_rev:
                cig_sam = list(reversed(cigars[m]))
                clip5, clip3 = L - r.qe, r.qb
                pos2l = 2 * l_pac - r.re
            else:
                cig_sam = cigars[m]
                clip5, clip3 = r.qb, L - r.qe
                pos2l = r.rb
            rid, pos = self.index.pos_to_ref(pos2l)
            # a region crossing a contig boundary is dropped
            if pos + (r.re - r.rb) > self._ann_lens[rid]:
                continue
            full = ([("N", clip5)] if clip5 else []) + cig_sam \
                + ([("N", clip3)] if clip3 else [])
            mapq = self._mapq(r) if r.secondary < 0 else 0
            hits_per_read[b].append(dict(
                rid=rid, pos=pos, is_rev=is_rev, score=r.score,
                mapq=mapq, secondary=r.secondary >= 0,
                cigar=full, nm=nms_by_row[m], n_regs=len(regions[b]),
                slot=slot_of[b].get(id(r), -1), sec=r.secondary))
        return hits_per_read

    # ------------------------------------------------------------------
    # host: MAPQ, contig resolution, columnar hits
    # ------------------------------------------------------------------

    def _hits_cols_from_full(self, enc, lens, res):
        """Columnar hits (grouped by read, aligner append order) from the
        device program's outputs, ready for ``native.bam_encode_hits``.
        Returns None (and counts ``fused_overflow_fallback``) when the
        extension DP rows overflowed: the caller reruns the batch through
        the classic path."""
        opt = self.options
        regions = res[0].cpu().numpy()
        snm = res[1].cpu().numpy()
        packed = res[2].cpu().numpy()
        B = enc.shape[0]
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
            self._count(fused_overflow_fallback=1)
            return None
        n_dp = int(regions[0, extra0 + 5]) if B else 0
        run_rows, run_ops, run_lens = _ops_to_runs(_unpack_ops(packed), n_dp)

        # host global pass for wide/overflow regions (rare)
        flags = fields[:, :, 8]
        live = (flags & FLAG_EMIT) != 0
        scoref = fields[:, :, 4]
        fb_rows = []
        for b, j in zip(*np.nonzero(live & (scoref >= opt.T)
                                    & ((flags & (FLAG_WIDE | FLAG_OVER))
                                       != 0))):
            fb_rows.append((b, j))
            if flags[b, j] & FLAG_WIDE:
                self._count(regions_widened=1)
        keep_fb: list[tuple] = []
        fb_nm = np.zeros(0, np.int32)
        if fb_rows:
            Lq = enc.shape[1]
            Lt_wide = Lq + 512
            for b, j in fb_rows:
                if fields[b, j, 1] - fields[b, j, 0] <= Lq \
                        and fields[b, j, 3] - fields[b, j, 2] <= Lt_wide:
                    keep_fb.append((b, j))
                else:
                    self._count(regions_dropped_wide=1)
            if keep_fb:
                M = _bucket(len(keep_fb))
                q = np.full((M, Lq), 4, np.uint8)
                t = np.full((M, Lt_wide), 4, np.uint8)
                ql = np.zeros(M, np.int32)
                tl = np.zeros(M, np.int32)
                for k, (b, j) in enumerate(keep_fb):
                    qb, qe, rb, re = fields[b, j, :4]
                    ql[k] = qe - qb
                    tl[k] = re - rb
                    q[k, :ql[k]] = enc[b, qb:qe]
                    t[k, :tl[k]] = self.text[rb:re]
                dev = self.device
                snm2, packed2 = global_and_traceback_packed(
                    torch.from_numpy(q).to(dev), torch.from_numpy(ql).to(dev),
                    torch.from_numpy(t).to(dev), torch.from_numpy(tl).to(dev),
                    o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                    e_ins=opt.e_ins, match=opt.a, mismatch=opt.b,
                    band=Lt_wide + 8)
                fb_nm = snm2.cpu().numpy()[:len(keep_fb), 1].astype(np.int32)
                fb_rr, fb_ro, fb_rl = _ops_to_runs(
                    _unpack_ops(packed2.cpu().numpy()), len(keep_fb))
                run_rows = np.concatenate([run_rows, fb_rr + n_dp])
                run_ops = np.concatenate([run_ops, fb_ro])
                run_lens = np.concatenate([run_lens, fb_rl])

        l_pac = self.index.l_pac
        qb_a = fields[:, :, 0]; qe_a = fields[:, :, 1]
        rb_a = fields[:, :, 2]; re_a = fields[:, :, 3]
        sc_a = fields[:, :, 4]
        emit = live & (sc_a >= opt.T)
        dprow_a = fields[:, :, 9]
        has_cig = (dprow_a >= 0) | ((flags & FLAG_PERFECT) != 0)
        is_rev = rb_a >= l_pac
        L_a = lens[:, None].astype(np.int64)
        clip5 = np.where(is_rev, L_a - qe_a, qb_a)
        clip3 = np.where(is_rev, qb_a, L_a - qe_a)
        pos2l = np.where(is_rev, 2 * l_pac - re_a, rb_a)
        offs = self._ann_offs
        rid_a = np.searchsorted(offs, pos2l, side="right") - 1
        pos_a = pos2l - offs[rid_a]
        in_contig = pos_a + (re_a - rb_a) <= self._ann_lens[rid_a]
        sec_mask = fields[:, :, 7] >= 0
        # float64 mem_approx_mapq_se
        sub_a2 = np.where(fields[:, :, 5] > 0, fields[:, :, 5],
                          opt.min_seed_len * opt.a).astype(np.float64)
        length = np.maximum(qe_a - qb_a, re_a - rb_a).astype(np.float64)
        length = np.maximum(length, 1.0)
        ident = 1.0 - (length * opt.a - sc_a) / (opt.a + opt.b) / length
        tmp = np.where(length < opt.mapQ_coef_len, 1.0,
                       opt.mapQ_coef_fac / np.log(np.maximum(length, 2.0)))
        tmp = tmp * ident * ident
        mq = (6.02 * (sc_a - sub_a2) / opt.a * tmp * tmp
              + 0.499).astype(np.int64)
        subn_f = fields[:, :, 6]
        mq = mq - np.where(subn_f > 0,
                           (4.343 * np.log(subn_f + 1) + 0.499)
                           .astype(np.int64), 0)
        mq = np.clip(mq, 0, 60)
        frac = rep_cov.astype(np.float64) / np.maximum(lens, 1)[:B]
        mq = (mq * (1.0 - frac[:, None]) + 0.499).astype(np.int64)
        mq = np.where(sub_a2 >= sc_a, 0, mq)
        mq = np.where(sec_mask, 0, mq)

        # ---- columnar hit assembly ------------------------------------
        b_m, j_m = np.nonzero(emit & has_cig & in_contig)
        perf_m = (flags[b_m, j_m] & FLAG_PERFECT) != 0
        d_m = np.where(perf_m, 0, dprow_a[b_m, j_m]).astype(np.int64)
        if run_rows.size:
            off_m = np.searchsorted(run_rows, d_m).astype(np.int64)
            cnt_m = (np.searchsorted(run_rows, d_m, side="right")
                     - off_m).astype(np.int32)
        else:
            off_m = np.zeros(d_m.size, np.int64)
            cnt_m = np.zeros(d_m.size, np.int32)
        off_m = np.where(perf_m, 0, off_m)
        cnt_m = np.where(perf_m, 0, cnt_m).astype(np.int32)
        if n_dp:
            nm_m = np.where(perf_m, 0, snm[np.clip(d_m, 0, n_dp - 1), 1]
                            ).astype(np.int32)
        else:
            nm_m = np.zeros(d_m.size, np.int32)
        mlen_m = np.where(perf_m, qe_a[b_m, j_m] - qb_a[b_m, j_m],
                          0).astype(np.int32)
        # fallback-path regions come after the main slots of their read
        fb_b, fb_j, fb_off, fb_cnt, fb_nm_k = [], [], [], [], []
        for k, (b, j) in enumerate(keep_fb):
            if not in_contig[b, j]:
                continue
            d = n_dp + k
            o = int(np.searchsorted(run_rows, d))
            e = int(np.searchsorted(run_rows, d, side="right"))
            fb_b.append(b); fb_j.append(j)
            fb_off.append(o); fb_cnt.append(e - o)
            fb_nm_k.append(int(fb_nm[k]))
        ab = np.concatenate([b_m, np.array(fb_b, np.int64)]).astype(np.int64)
        aj = np.concatenate([j_m, np.array(fb_j, np.int64)]).astype(np.int64)
        off_all = np.concatenate([off_m, np.array(fb_off, np.int64)])
        cnt_all = np.concatenate([cnt_m, np.array(fb_cnt, np.int32)])
        nm_all = np.concatenate([nm_m, np.array(fb_nm_k, np.int32)])
        mlen_all = np.concatenate([mlen_m, np.zeros(len(fb_b), np.int32)])
        order = np.argsort(ab, kind="stable")
        ab, aj = ab[order], aj[order]
        return dict(
            read_idx=ab.astype(np.int32),
            rid=rid_a[ab, aj].astype(np.int32),
            pos=pos_a[ab, aj].astype(np.int32),
            is_rev=is_rev[ab, aj].astype(np.uint8),
            is_sec=sec_mask[ab, aj].astype(np.uint8),
            score=sc_a[ab, aj].astype(np.int32),
            mapq=mq[ab, aj].astype(np.int32),
            nm=np.ascontiguousarray(nm_all[order], np.int32),
            n_regs=n_regs[ab].astype(np.int32),
            slot=aj.astype(np.int32),
            sec=fields[ab, aj, 7].astype(np.int32),
            clip5=clip5[ab, aj].astype(np.int32),
            clip3=clip3[ab, aj].astype(np.int32),
            cig_off=np.ascontiguousarray(off_all[order], np.int64),
            cig_n=np.ascontiguousarray(cnt_all[order], np.int32),
            match_len=np.ascontiguousarray(mlen_all[order], np.int32),
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
            cols = _filter_cols(cols, mask)
        opt = self.options
        ksf = keep_sec_frac
        if keep_sec_frac < 0.0 or keep_sec_frac > 1.0:
            cols = _filter_cols(cols, cols["is_sec"] == 0)
            ksf = 0.0
        qn = [r.name.encode() for r in chunk]
        sq = [r.seq.encode() for r in chunk]
        qname_off = np.zeros(B + 1, np.int64)
        np.cumsum(np.array([len(x) for x in qn], np.int64),
                  out=qname_off[1:])
        seq_off = np.zeros(B + 1, np.int64)
        np.cumsum(np.array([len(x) for x in sq], np.int64), out=seq_off[1:])
        ref_blob, ref_off = self._ref_name_arrays()
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
        while the next batch runs; yields finish's results in order."""

        def batches():
            buf = []
            for r in read_iter:
                buf.append(r)
                if len(buf) >= batch_size:
                    yield buf
                    buf = []
            if buf:
                yield buf

        with _fut.ThreadPoolExecutor(max(workers, 1)) as pool:
            inflight: list = []
            for chunk in batches():
                enc, lens = self._encode_batch([r.seq for r in chunk])
                res = self._dispatch_full(enc, lens)
                inflight.append(pool.submit(finish, chunk, enc, lens, res))
                while len(inflight) >= max(workers, 1) + 1:
                    yield inflight.pop(0).result()
            for f in inflight:
                yield f.result()

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
            B = enc.shape[0]
            return self._regions_to_hits(
                enc, lens, self._collect_regions(enc, lens)[:B])
        return self._cols_to_hit_dicts(cols, enc.shape[0])

    def _cols_to_hit_dicts(self, cols, B):
        """Columnar hits -> per-read dict lists (object-API shape)."""
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
