"""BWA-MEM-style single-end aligner, fused path (counterpart of
seqlib_tpu/align/aligner.py).

``align_batch_bam`` / ``align_stream_bam`` encode a batch, run the whole
device program (``device_full.align_full``: SMEM seeding on kernel K2,
SA locate, chaining, banded extension on kernel K1, dedup and primary
marking, global DP and traceback), then compute float64 MAPQ on the
host and emit SAM/BAM records through the native C++ encoder
(``native/bamenc.cpp``).  The output is byte-identical to
``seqlib_tpu``'s same entry points.

This slice covers the fused path only.  A batch whose extension DP
rows overflow ``dp_rows(B)`` (the JAX package reruns it through its
classic path) and reads longer than ``LONG_READ_BP`` raise
:class:`FusedOverflowError`; no read is ever dropped and no partial
output is returned.
"""

from __future__ import annotations

import collections
import concurrent.futures as _fut
import threading

import numpy as np
import torch

from .. import native as _native
from ..core.seq import NT4_TABLE
from ..device import resolve_device
from ..index.pack import both_strands
from ..ops.fm import DeviceFMIndex
from .device_full import (FLAG_EMIT, FLAG_OVER, FLAG_PERFECT, FLAG_WIDE,
                          NFIELD, align_full)
from .device_pipeline import ESC_SLOTS, dp_rows, global_and_traceback_packed
from .options import AlignerOptions

MAX_SEEDS = 16          # per read from the seed scan
MAX_OCC_LOCATE = 16     # occurrences located per seed
MAX_CHAINS = 4          # chains extended per read
REGION_SLOTS = MAX_CHAINS + ESC_SLOTS
LONG_READ_BP = 1024     # the fused path's packed chain keys cap reads here


class FusedOverflowError(RuntimeError):
    """The fused path cannot align this batch exactly: more non-trivial
    chains than extension DP rows, or reads over LONG_READ_BP.  The
    JAX package reruns such batches through its classic path, which
    this port does not have yet."""

    def __init__(self, msg: str, batch_size: int = 0, n_dp: int = 0,
                 limit: int = 0):
        super().__init__(msg)
        self.batch_size = batch_size
        self.n_dp = n_dp
        self.limit = limit


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
    versions)."""

    def __init__(self, index, options: AlignerOptions | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        if index.seq_len >= 2**31:
            raise NotImplementedError(
                "indexes with a 2L text of 2^31 or more are not ported yet")
        self.index = index
        self.options = options or AlignerOptions()
        self.text = both_strands(index.ref.codes)
        self.fm = DeviceFMIndex.from_host(index, device=self.device)
        self.text_t = torch.from_numpy(self.text).to(self.device)
        # truncation telemetry; align_stream_bam's host threads update it
        self.stats = dict(seeds_at_cap=0, occ_clipped=0, chains_at_cap=0,
                          regions_widened=0, regions_dropped_wide=0,
                          escapees_deferred=0)
        self._stats_lock = threading.Lock()
        self._ann_offs = index.contig_offsets()
        self._ann_lens = index.contig_lengths()
        self._ref_blob_cache = None

    def reset_stats(self):
        with self._stats_lock:
            for k in self.stats:
                self.stats[k] = 0

    def _count(self, **inc):
        with self._stats_lock:
            for k, v in inc.items():
                self.stats[k] += int(v)

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
        if int(lens.max(initial=0)) > LONG_READ_BP:
            raise FusedOverflowError(
                f"reads longer than {LONG_READ_BP} bp exceed the fused "
                "path's packed chain keys", batch_size=enc.shape[0])
        opt = self.options
        enc_lens = np.concatenate(
            [enc, lens.astype("<u4").view(np.uint8).reshape(-1, 4)], axis=1)
        return align_full(
            self.fm, self.text_t,
            torch.from_numpy(enc_lens).to(self.device),
            l_pac=self.index.l_pac, max_seeds=MAX_SEEDS,
            min_seed_len=opt.min_seed_len, max_occ=opt.max_occ,
            k_occ=MAX_OCC_LOCATE, band=opt.w,
            max_chain_gap=opt.max_chain_gap, drop_ratio=opt.drop_ratio,
            max_chains=MAX_CHAINS, o_del=opt.o_del, e_del=opt.e_del,
            o_ins=opt.o_ins, e_ins=opt.e_ins, match=opt.a,
            mismatch=opt.b, pen_clip5=opt.pen_clip5,
            pen_clip3=opt.pen_clip3, w=opt.w, zdrop=opt.zdrop,
            T=opt.T, mask_level=opt.mask_level,
            mask_level_redun=opt.mask_level_redun,
            glob_band=2 * opt.w + 8,
            split_len=opt.split_len, split_width=opt.split_width,
            min_chain_weight=opt.min_chain_weight,
            max_chain_extend=opt.max_chain_extend,
            max_mem_intv=opt.max_mem_intv)

    # ------------------------------------------------------------------
    # host: MAPQ, contig resolution, columnar hits
    # ------------------------------------------------------------------

    def _hits_cols_from_full(self, enc, lens, res):
        """Columnar hits (grouped by read, aligner append order) from the
        device program's outputs, ready for ``native.bam_encode_hits``.
        Raises FusedOverflowError when the extension DP rows overflowed."""
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
        if B and int(regions[0, extra0 + 6]) > dp_rows(B):
            raise FusedOverflowError(
                f"extension DP rows overflowed: {int(regions[0, extra0 + 6])}"
                f" non-trivial chains > dp_rows({B}) = {dp_rows(B)}",
                batch_size=B, n_dp=int(regions[0, extra0 + 6]),
                limit=dp_rows(B))
        self._count(occ_clipped=regions[:, extra0 + 2].sum(),
                    seeds_at_cap=regions[:, extra0 + 3].sum(),
                    chains_at_cap=(regions[:, extra0 + 4] > MAX_CHAINS).sum(),
                    escapees_deferred=regions[:, extra0 + 7].sum())
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
            enc_names = [n.encode() for n in self.index.contig_names()]
            off = np.zeros(len(enc_names) + 1, np.int64)
            np.cumsum(np.array([len(b) for b in enc_names], np.int64),
                      out=off[1:])
            blob = np.frombuffer(b"".join(enc_names), np.uint8)
            self._ref_blob_cache = (blob, off)
        return self._ref_blob_cache

    def _payload_batch(self, chunk, enc, lens, res, hardclip,
                       keep_sec_frac, max_secondary, sam=False):
        """Device outputs -> serialized BAM records (or SAM text) and
        per-read record counts, through native/bamenc.cpp."""
        B = len(chunk)
        cols = self._hits_cols_from_full(enc, lens, res)
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

    def align_stream_bam(self, read_iter, batch_size: int = 4096,
                         hardclip: bool = False, keep_sec_frac: float = 0.9,
                         max_secondary: int = 10, workers: int = 2,
                         sam: bool = False):
        """Streaming alignment: yields (chunk, payload, counts) per batch
        of ``batch_size`` reads (objects with ``.name`` and ``.seq``), in
        order.  Host record emission of one batch runs on a small
        thread pool while the next batch runs on the device."""

        def batches():
            buf = []
            for r in read_iter:
                buf.append(r)
                if len(buf) >= batch_size:
                    yield buf
                    buf = []
            if buf:
                yield buf

        def finish(args):
            chunk, enc, lens, res = args
            payload, counts = self._payload_batch(
                chunk, enc, lens, res, hardclip, keep_sec_frac,
                max_secondary, sam)
            return chunk, payload, counts

        with _fut.ThreadPoolExecutor(max(workers, 1)) as pool:
            inflight: list = []
            for chunk in batches():
                enc, lens = self._encode_batch([r.seq for r in chunk])
                res = self._dispatch_full(enc, lens)
                inflight.append(pool.submit(finish, (chunk, enc, lens, res)))
                while len(inflight) >= max(workers, 1) + 1:
                    yield inflight.pop(0).result()
            for f in inflight:
                yield f.result()
