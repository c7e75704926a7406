"""Paired-end alignment: insert-size inference, mate rescue, pair flags
and supplementary marking (counterpart of seqlib_tpu/align/pairing.py,
whose reconstruction of bwa-mem's pairing it follows exactly).

* ``infer_dir``: mem_infer_dir's algebra.  Mate 2 is flipped onto mate
  1's strand in 2L space; the orientation is one of FF=0, FR=1, RF=2,
  RR=3, and the distance is leftmost to leftmost.
* ``infer_isize_stats``: mem_pestat.  Per orientation, quartiles, an
  outlier-trimmed mean and standard deviation, and the [low, high]
  proper-pair bounds; rare orientations are failed.
* ``rescue_candidates``: mem_matesw.  A local Smith-Waterman
  (``ops.sw.local_batch``) of each unaligned mate against the 2L window
  each enabled orientation implies; hits scoring at least
  min_seed_len * a become regions.
* ``pair_up``: mem_sam_pe's flags, mate fields and TLEN.
* ``align_pairs``: one batch of pairs through all of the above; rescued
  regions go through the aligner's dedup, global DP and record assembly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.record import (FMREVERSE, FMUNMAP, FPAIRED, FPROPER_PAIR,
                           FREAD1, FREAD2, FSUPPLEMENTARY, BamRecord)
from ..core.seq import encode_nt4
from ..ops.sw import LOCAL_MAX_LEN, local_batch
from .aligner import AlnReg

FF, FR, RF, RR = 0, 1, 2, 3
DIR_NAMES = ("FF", "FR", "RF", "RR")

MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0


def mark_supplementary(recs: list[BamRecord]) -> list[BamRecord]:
    """Among one read's non-secondary records, the first (best) stays the
    representative and the rest are flagged supplementary (0x800)."""
    seen_primary = False
    for r in recs:
        if r.secondary_flag():
            continue
        if seen_primary:
            r.flag |= FSUPPLEMENTARY
        else:
            seen_primary = True
    return recs


def _primary(recs: list[BamRecord]) -> BamRecord | None:
    for r in recs:
        if not r.secondary_flag() and not r.supplementary_flag():
            return r
    return None


def _rb_2l(rec: BamRecord, l_pac: int, offs) -> int:
    """A record's leftmost 2L-text coordinate (bwa's alnreg rb): a forward
    hit keeps its genome coordinate, a reverse hit maps to the reverse
    half.  ``offs``: contig offsets indexed by tid."""
    g0 = int(offs[rec.tid]) + rec.pos
    if not rec.reverse_flag():
        return g0
    return 2 * l_pac - (int(offs[rec.tid]) + rec.position_end())


def infer_dir(l_pac: int, b1: int, b2: int) -> tuple[int, int]:
    """(orientation, distance) of two 2L leftmost coordinates: mate 2 is
    flipped onto mate 1's strand; the distance is |leftmost - leftmost|
    on that strand."""
    r1 = b1 >= l_pac
    r2 = b2 >= l_pac
    p2 = b2 if r1 == r2 else 2 * l_pac - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    d = (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3)
    return d, dist


@dataclass
class DirStats:
    failed: bool = True
    low: int = 0
    high: int = 0
    avg: float = 0.0
    std: float = 0.0
    count: int = 0


@dataclass
class InsertSizeStats:
    l_pac: int
    dirs: list[DirStats] = field(default_factory=lambda:
                                 [DirStats() for _ in range(4)])

    def enabled(self):
        return [d for d in range(4) if not self.dirs[d].failed]


def infer_isize_stats(pairs, l_pac: int, offs,
                      min_mapq: int = 20) -> InsertSizeStats:
    """mem_pestat over (recs1, recs2) pairs whose primaries are both
    mapped, on one contig, with mapq >= min_mapq.  Per orientation with
    at least MIN_DIR_CNT observations: quartiles, then the mean and
    standard deviation of the values within OUTLIER_BOUND IQRs, then

        low  = max(1, p25 - MAPPING_BOUND*(p75-p25)),
        high = p75 + MAPPING_BOUND*(p75-p25),

    widened to avg -+ MAX_STDDEV*std where that is wider.  Orientations
    with fewer than MIN_DIR_RATIO of the commonest one's count fail."""
    dists: list[list[int]] = [[], [], [], []]
    for recs1, recs2 in pairs:
        p1, p2 = _primary(recs1), _primary(recs2)
        if p1 is None or p2 is None:
            continue
        if not p1.mapped_flag() or not p2.mapped_flag():
            continue
        if p1.tid != p2.tid or p1.mapq < min_mapq or p2.mapq < min_mapq:
            continue
        d, dist = infer_dir(l_pac, _rb_2l(p1, l_pac, offs),
                            _rb_2l(p2, l_pac, offs))
        dists[d].append(dist)
    st = InsertSizeStats(l_pac=l_pac)
    for d in range(4):
        v = sorted(dists[d])
        n = len(v)
        ds = st.dirs[d]
        ds.count = n
        if n < MIN_DIR_CNT:
            continue
        p25 = v[int(0.25 * n + 0.499)]
        p50 = v[int(0.50 * n + 0.499)]
        p75 = v[int(0.75 * n + 0.499)]
        iqr = p75 - p25
        lo_t = p25 - OUTLIER_BOUND * iqr
        hi_t = p75 + OUTLIER_BOUND * iqr
        core = [x for x in v if lo_t <= x <= hi_t]
        ds.avg = float(np.mean(core)) if core else float(p50)
        ds.std = float(np.std(core)) if core else 0.0
        ds.high = int(p75 + MAPPING_BOUND * iqr + 0.499)
        ds.low = max(1, int(p25 - MAPPING_BOUND * iqr + 0.499))
        if ds.high < ds.avg + MAX_STDDEV * ds.std:
            ds.high = int(ds.avg + MAX_STDDEV * ds.std + 0.499)
        if ds.low > ds.avg - MAX_STDDEV * ds.std:
            ds.low = max(1, int(ds.avg - MAX_STDDEV * ds.std + 0.499))
        ds.failed = False
    max_cnt = max(d.count for d in st.dirs)
    for ds in st.dirs:
        if not ds.failed and ds.count < MIN_DIR_RATIO * max_cnt:
            ds.failed = True
    return st


def mate_window(stats: InsertSizeStats, d: int, b_anchor: int,
                l_mate: int) -> tuple[int, int] | None:
    """2L window of the mate's leftmost coordinate under orientation
    ``d`` (:func:`infer_dir` inverted for dist in [low, high]), grown by
    the mate length and clamped to the half its midpoint lies on; None
    when the orientation failed or the window is shorter than half the
    mate."""
    ds = stats.dirs[d]
    if ds.failed:
        return None
    l_pac = stats.l_pac
    L2 = 2 * l_pac
    if d in (FF, RR):
        lo, hi = ((b_anchor + ds.low, b_anchor + ds.high) if d == FF
                  else (b_anchor - ds.high, b_anchor - ds.low))
    elif d == FR:         # flipped: b2 = 2*l_pac - 1 - (b1 +- dist)
        lo = L2 - 1 - b_anchor - ds.high
        hi = L2 - 1 - b_anchor - ds.low
    else:                 # RF
        lo = L2 - 1 - b_anchor + ds.low
        hi = L2 - 1 - b_anchor + ds.high
    beg, end = lo, hi + l_mate
    mid = (beg + end) // 2
    half_lo, half_hi = (0, l_pac) if mid < l_pac else (l_pac, L2)
    beg = max(beg, half_lo)
    end = min(end, half_hi)
    if end - beg < l_mate // 2:
        return None
    return beg, end


def rescue_candidates(aligner, stats: InsertSizeStats,
                      jobs: list[tuple[int, str, int]]):
    """mem_matesw over a batch: ``jobs`` = (job_id, mate_seq,
    anchor_rb_2l).  Every (job, enabled orientation) window goes through
    one ``local_batch`` call on the aligner's device; returns {job_id:
    [AlnReg, ...]} for hits scoring >= min_seed_len * a.  As in the JAX
    package, a call whose widest window exceeds ``local_batch``'s cap
    rescues nothing; ``stats["rescue_windows_dropped"]`` counts its
    windows."""
    opt = aligner.options
    text = aligner.text
    lanes = []           # (job_id, seq, wbeg, wlen)
    for job_id, seq, b_anchor in jobs:
        for d in stats.enabled():
            win = mate_window(stats, d, b_anchor, len(seq))
            if win is not None:
                lanes.append((job_id, seq, win[0], win[1] - win[0]))
    out: dict[int, list] = {}
    if not lanes:
        return out
    Lq = max(len(s) for _, s, _, _ in lanes)
    Lt = max(w for _, _, _, w in lanes)
    if Lt > LOCAL_MAX_LEN:
        aligner._count(rescue_windows_dropped=len(lanes))
        return out
    B = len(lanes)
    q = np.full((B, Lq), 4, np.uint8)
    t = np.full((B, Lt), 4, np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for k, (_, seq, wbeg, wlen) in enumerate(lanes):
        q[k, :len(seq)] = encode_nt4(seq)
        ql[k] = len(seq)
        t[k, :wlen] = text[wbeg:wbeg + wlen]
        tl[k] = wlen
    dev = aligner.device
    res = local_batch(*(torch.from_numpy(a).to(dev) for a in (q, ql, t, tl)),
                      o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                      e_ins=opt.e_ins, match=opt.a, mismatch=opt.b)
    score, qb, qe, tb, te = (res[k].cpu().numpy()
                             for k in ("score", "qb", "qe", "tb", "te"))
    thr = opt.min_seed_len * opt.a
    for k, (job_id, _, wbeg, _) in enumerate(lanes):
        if score[k] < thr:
            continue
        out.setdefault(job_id, []).append(AlnReg(
            rb=wbeg + int(tb[k]), re=wbeg + int(te[k]), qb=int(qb[k]),
            qe=int(qe[k]), score=int(score[k]), seedcov=int(score[k]),
            frac_rep=0.0))
    return out


def pair_up(recs1: list[BamRecord], recs2: list[BamRecord],
            stats: InsertSizeStats | None = None, offs=None,
            max_isize: int = 1000) -> None:
    """Set pair flags, mate fields and TLEN across the two ends' records
    (in place).  With ``stats`` and ``offs``, a pair is proper iff its
    orientation is enabled and its 2L distance lies in that orientation's
    [low, high]; without, iff it is FR within ``max_isize``."""
    p1, p2 = _primary(recs1), _primary(recs2)
    for r in recs1:
        r.flag |= FPAIRED | FREAD1
    for r in recs2:
        r.flag |= FPAIRED | FREAD2
    for me, other_primary in ((recs1, p2), (recs2, p1)):
        for r in me:
            if other_primary is None or not other_primary.mapped_flag():
                r.flag |= FMUNMAP
                r.mtid, r.mpos = -1, -1
                continue
            r.mtid = other_primary.tid
            r.mpos = other_primary.pos
            if other_primary.reverse_flag():
                r.flag |= FMREVERSE
    if p1 is None or p2 is None or p1.tid != p2.tid \
            or not p1.mapped_flag() or not p2.mapped_flag():
        return
    left, right = (p1, p2) if p1.pos <= p2.pos else (p2, p1)
    isize = right.position_end() - left.pos
    left.isize = isize
    right.isize = -isize
    if stats is not None and offs is not None:
        d, dist = infer_dir(stats.l_pac, _rb_2l(p1, stats.l_pac, offs),
                            _rb_2l(p2, stats.l_pac, offs))
        ds = stats.dirs[d]
        proper = (not ds.failed) and ds.low <= dist <= ds.high
    else:
        proper = (not left.reverse_flag() and right.reverse_flag()
                  and 0 < isize <= max_isize)
    if proper:
        for r in (p1, p2):
            r.flag |= FPROPER_PAIR


def _rescued_records(aligner, found, jobs_meta, seqs, names, hardclip,
                     keep_sec_frac, max_secondary):
    """Records of the rescued mates: {(side, pair): records}.  Rescued
    regions take the single-end path's dedup, global DP and assembly, in
    one call per encoded read width (rows are independent, so a read's
    records do not depend on the others in its call)."""
    groups: dict[int, list[int]] = {}
    for job_id in found:
        side, i = jobs_meta[job_id]
        width = -(-len(seqs[side][i]) // 32) * 32
        groups.setdefault(width, []).append(job_id)
    out = {}
    for job_ids in groups.values():
        keys = [jobs_meta[j] for j in job_ids]
        gseqs = [seqs[side][i] for side, i in keys]
        enc, lens = aligner._encode_batch(gseqs)
        regions = [aligner._dedup_and_mark(found[j]) for j in job_ids]
        regions += [[] for _ in range(enc.shape[0] - len(regions))]
        hits = aligner._regions_to_hits(enc, lens, regions)
        for k, (side, i) in enumerate(keys):
            out[(side, i)] = aligner._assemble_records(
                gseqs[k], names[i], hits[k], hardclip, keep_sec_frac,
                max_secondary)
    return out


def align_pairs(aligner, seqs1: list[str], seqs2: list[str],
                names: list[str], hardclip: bool = False,
                keep_sec_frac: float = 0.9, max_secondary: int = 10,
                stats: InsertSizeStats | None = None, rescue: bool = True):
    """Paired-end alignment of one batch: both ends through
    ``align_batch``, the insert-size distribution inferred from the batch
    (or ``stats`` as given), mate rescue for each end with no record
    whose mate has a confident primary, then supplementary marking and
    pair flags, mates and TLEN.

    Returns (records1, records2, stats); pass ``stats`` back in for later
    batches of the same library to keep its distribution.  A sharded
    aligner has no single 2L space: its pairs get flags, mates and TLEN
    only (no inference, no rescue), and stats comes back None."""
    out1 = aligner.align_batch(seqs1, names, hardclip=hardclip,
                               keep_sec_frac=keep_sec_frac,
                               max_secondary=max_secondary)
    out2 = aligner.align_batch(seqs2, names, hardclip=hardclip,
                               keep_sec_frac=keep_sec_frac,
                               max_secondary=max_secondary)
    l_pac = getattr(aligner.index, "l_pac", None)
    offs = getattr(aligner, "_ann_offs", None)
    if l_pac is None or offs is None:
        for recs1, recs2 in zip(out1, out2):
            mark_supplementary(recs1)
            mark_supplementary(recs2)
            pair_up(recs1, recs2)
        return out1, out2, None
    if stats is None:
        stats = infer_isize_stats(zip(out1, out2), l_pac, offs)
    if rescue and stats.enabled():
        jobs, meta = [], []             # meta: (side, pair index)
        for i in range(len(names)):
            for side, (mine, other, mseq) in enumerate(
                    ((out1[i], out2[i], seqs1[i]),
                     (out2[i], out1[i], seqs2[i]))):
                if _primary(mine) is not None:
                    continue
                po = _primary(other)
                if po is None or not po.mapped_flag() or po.mapq == 0:
                    continue
                jobs.append((len(jobs), mseq, _rb_2l(po, l_pac, offs)))
                meta.append((side, i))
        found = rescue_candidates(aligner, stats, jobs)
        rescued = _rescued_records(aligner, found, meta, (seqs1, seqs2),
                                   names, hardclip, keep_sec_frac,
                                   max_secondary)
        for (side, i), recs in rescued.items():
            if recs:
                (out1 if side == 0 else out2)[i] = recs
    for recs1, recs2 in zip(out1, out2):
        mark_supplementary(recs1)
        mark_supplementary(recs2)
        pair_up(recs1, recs2, stats=stats, offs=offs)
    return out1, out2, stats
