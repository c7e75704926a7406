# Adapted from seqlib_tpu_torch/align/aligner.py for the benchmark's reference:
# the classic per-read path alone, on the plain PyTorch operations.
"""BWA-MEM-style single-end aligner, the benchmark's reference.

``align_batch`` takes bwa mem's classic route, read by read: seed scan,
SA locate, chaining and extension (``device_pipeline.seed_chain_extend``,
on the plain PyTorch operations), then, on the host and one read at a
time, bwa's ``mem_sort_dedup_patch`` and ``mem_mark_primary_se``
(``_dedup_and_mark``), float64 ``mem_approx_mapq_se`` (``_mapq``), the
banded global DP and traceback of every region kept
(``_regions_to_hits``), and the records with their XA, NM, AS and NA
tags (``_assemble_records``), encoded by ``io.bam.encode_record``.

It is not the port's timed engine: that runs the fused batch program
(dedup, primary marking and the compaction of global-DP rows on the
device, under a batch-wide budget of DP rows) and computes MAPQ and
records column-wise in numpy and C++.  Here no cap spans the batch:
when a batch's chains overflow the compacted extension's rows, every
chain is extended again uncompacted, so a read's records do not depend
on the reads beside it.  The per-read caps (16 seeds, 4 chains, 8
regions) are the JAX package's and the port's semantics and stay.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..core.cigar import Cigar, CigarField
from ..core.record import FREVERSE, FSECONDARY, BamRecord
from ..core.seq import NT4_TABLE, revcomp
from ..device import resolve_device
from ..index.pack import both_strands
from ..ops.fm import DeviceFMIndex
from .device_pipeline import (dp_rows, extend_chains,
                              global_and_traceback_packed,
                              seed_chain_extend)
from .options import AlignerOptions

MAX_SEEDS = 16          # per read from the seed scan
MAX_OCC_LOCATE = 16     # occurrences located per seed
MAX_CHAINS = 4          # chains extended per read
MAX_REGS = 8            # alignment regions kept per read (classic path)
# the global DP's direction matrix is M x Lq x (Lt + 1) bytes: regions go
# through it in groups of at most this many bytes (rows are independent)
GLOBAL_DP_BYTES = 4 << 30


@dataclass
class AlnReg:
    """mem_alnreg_t equivalent (coordinates in 2L text space)."""
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


_M64 = (1 << 64) - 1


def _hash64(key: int) -> int:
    """Thomas Wang's 64-bit mix (bwa's hash_64): the equal-score
    tie-break of mem_mark_primary_se."""
    key = (key + (~(key << 32) & _M64)) & _M64
    key ^= key >> 22
    key = (key + (~(key << 13) & _M64)) & _M64
    key ^= key >> 8
    key = (key + (key << 3)) & _M64
    key ^= key >> 15
    key = (key + (~(key << 27) & _M64)) & _M64
    key ^= key >> 31
    return key


class BWAAligner:
    """Single-end aligner over the reference's own FM-index, on
    ``device`` (the plain PyTorch operations on the CPU or the card)."""

    def __init__(self, index, options: AlignerOptions | None = None,
                 device="cpu"):
        self.device = resolve_device(device)
        self.index = index
        self.options = options or AlignerOptions()
        self.text = both_strands(index.ref.codes)
        self.fm = DeviceFMIndex.from_host(index, device=self.device,
                                          wide=index.seq_len >= 2**31)
        self.text_t = torch.from_numpy(self.text).to(self.device)
        # truncation telemetry
        self.stats = dict(seeds_at_cap=0, occ_clipped=0, chains_at_cap=0,
                          regs_truncated=0, regions_widened=0,
                          regions_dropped_wide=0, escapees_deferred=0)
        self._stats_lock = threading.Lock()
        self._ann_offs = index.contig_offsets()
        self._ann_lens = index.contig_lengths()
        self._names = index.contig_names()

    def reset_stats(self):
        with self._stats_lock:
            for k in self.stats:
                self.stats[k] = 0

    def _count(self, **inc):
        with self._stats_lock:
            for k, v in inc.items():
                self.stats[k] += int(v)

    def _encode_batch(self, seqs: list[str]):
        L = _round_up(max(len(s) for s in seqs), 32)
        Bp = _bucket(len(seqs), mn=8)
        lens = np.zeros(Bp, np.int64)
        lens[:len(seqs)] = [len(s) for s in seqs]
        enc = np.full((Bp, L), 4, np.uint8)
        codes = NT4_TABLE[np.frombuffer("".join(seqs).encode(), np.uint8)]
        enc[np.arange(L, dtype=np.int64)[None, :] < lens[:, None]] = codes
        return enc, lens

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
        extension) of an encoded batch, whole, on the aligner's
        device."""
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

    def _dedup_and_mark(self, regs: list[AlnReg]) -> list[AlnReg]:
        """mem_sort_dedup + mem_mark_primary_se semantics, one read's
        regions at a time."""
        opt = self.options

        def key(r):
            return r.rb, r.re
        # dedup near-identical regions, walking (-score, rb, qb, re)
        regs = sorted(regs, key=lambda r: (-r.score, r.rb, r.qb, r.re))
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
                snm, packed = self._global_dp(q, ql, t, tl, band)
                nms = snm[:, 1]
                dev_cigs = _ops_to_cigars_batch(_unpack_ops(packed), M)
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

    def _global_dp(self, q, ql, t, tl, band: int):
        """``global_and_traceback_packed`` of host rows -> (snm, packed)
        on the host."""
        opt = self.options
        snm, packed = global_and_traceback_packed(
            *(torch.from_numpy(a).to(self.device) for a in (q, ql, t, tl)),
            o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
            e_ins=opt.e_ins, match=opt.a, mismatch=opt.b, band=band)
        return snm.cpu().numpy(), packed.cpu().numpy()

    def align_batch(self, seqs: list[str], names: list[str],
                    hardclip: bool = False, keep_sec_frac: float = 0.9,
                    max_secondary: int = 10) -> list[list[BamRecord]]:
        """Per-read BamRecord lists (MAPQ sort, keepSecFrac/maxSecondary
        filters, clip rewrite, XA) by the classic path."""
        if not seqs:
            return []
        enc, lens = self._encode_batch(seqs)
        B = len(seqs)
        regions = self._collect_regions(enc, lens)[:B]
        if keep_sec_frac < 0.0 or keep_sec_frac > 1.0:
            regions = [[r for r in rs if r.secondary < 0] for rs in regions]
        hits = self._regions_to_hits(enc, lens, regions)
        return [self._assemble_records(seqs[b], names[b], hits[b], hardclip,
                                       keep_sec_frac, max_secondary)
                for b in range(B)]

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
