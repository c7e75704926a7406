"""Batched affine-gap DP: seed extension and banded global alignment
(counterpart of seqlib_tpu/ops/sw.py).

``extend_batch`` is bwa's ``ksw_extend`` over a batch: lanes are the
batch dimension, the target axis is a row vector, query rows run in a
Python loop, and the same-row deletion (E) dependency is a cumulative
max (E(j) = max_{j'<j}(Hnd(j') + e*j') - o - e*j).  With ``band > 0``
it is the plain version of kernel K1 (``csrc/sw_extend.cu``), which
must match it bit for bit, NEG surrogates included.  ``extend_rect``
(``band=0`` with the dead-row convention of the rectangle kernels) is
the plain version of kernels K3-K5 (``csrc/sw_rect.cu``).

``global_batch`` returns the packed direction matrix that
``align.device_pipeline.global_and_traceback`` walks on the device.
``local_batch`` is the local Smith-Waterman of mate rescue; the JAX
package computes it in XLA, with no TPU kernel, so it is plain torch on
every device.
"""

from __future__ import annotations

import torch

from .. import profiling

NEG = -0x40000000  # -inf surrogate that survives additions
NEG16 = -16384     # the TPU rectangle kernels' -inf surrogate
# the widest target the rectangle kernels take: they keep Lt + 1 columns
# in at most 32 threads of 32 register slots (csrc/sw_rect.cu's MAX_SLOTS)
RECT_MAX_LT = 1023

# extend_batch's running maxima are int64 (score, index) packs: the high
# 32 bits hold the score (+1 or +2, so never negative), the low 32 bits
# 2^32 - 1 - index, so one max prefers the higher score, then the smaller
# row or column at any length
_LOW32 = (1 << 32) - 1

# direction bits for global traceback
DIR_M, DIR_E, DIR_F = 0, 1, 2       # H source: diag / left(D) / up(I)
BIT_EEXT, BIT_FEXT = 4, 8
BIT_MIS = 16                        # q[i-1] != t[j-1] (for NM counting)


def _rows_to_run(qlen: torch.Tensor, Lq: int) -> int:
    """Query rows a row loop must run: a row at or past every lane's
    qlen leaves every output as it is."""
    if not qlen.numel():
        return 0
    with profiling.sync("sw.rows_to_run"):
        return min(Lq, int(qlen.max()))


def _row_scan_E(hnd: torch.Tensor, o_del: int, e_del: int) -> torch.Tensor:
    """E(j) = max_{j'<j}(hnd(j') + e_del*j') - o_del - e_del*j."""
    j = torch.arange(hnd.shape[-1], dtype=hnd.dtype, device=hnd.device)
    cm = torch.cummax(hnd + e_del * j, dim=-1).values
    cm = torch.cat([torch.full_like(cm[..., :1], NEG), cm[..., :-1]], dim=-1)
    return cm - o_del - e_del * j


def extend_batch(query, qlen, target, tlen, h0,
                 o_del: int = 6, e_del: int = 1,
                 o_ins: int = 6, e_ins: int = 1,
                 match: int = 1, mismatch: int = 4,
                 zdrop: int = 0, band: int = 0, return_rows: bool = False):
    """Batched seed extension (ksw_extend semantics incl. zdrop).

    query/target: nt4 codes [B, Lq] / [B, Lt] (4 = N, scored as a
    mismatch); qlen, tlen, h0 [B].  ``band > 0`` keeps only cells with
    |j - (i+1)| <= band (row 0 included; H and F dead outside).

    Returns int32 dict: score, qle, tle (best cell: highest score, then
    earliest row, then smallest column), gscore, gtle (best cell of the
    last query row, smallest column).  ``return_rows`` adds "rows", the
    number of DP rows each lane computed (for work counts)."""
    dev = query.device
    i32 = torch.int32
    B, Lq = query.shape
    Lt = target.shape[1]
    jt = torch.arange(Lt + 1, dtype=i32, device=dev)[None, :]
    trow = target.to(i32)
    qlen = qlen.to(i32)[:, None]
    h0 = h0.to(i32)
    neg = torch.tensor(NEG, dtype=i32, device=dev)

    h_row0 = h0[:, None] - torch.where(jt > 0, o_del + e_del * jt, 0)
    h_row0 = torch.where(h_row0 < 0, neg, h_row0)
    h_row0[:, 0] = h0
    tmask = jt <= tlen.to(i32)[:, None]
    h_row0 = torch.where(tmask, h_row0, neg)
    if band > 0:
        h_row0 = torch.where(jt <= band, h_row0, neg)

    h_prev = h_row0
    f_prev = torch.full((B, Lt + 1), NEG, dtype=i32, device=dev)
    best_pack = torch.full((B, Lt + 1), -1, dtype=torch.int64, device=dev)
    g_row = f_prev.clone()
    jt64 = jt.to(torch.int64)
    zbest = h0.clone()
    zbi = torch.zeros(B, dtype=i32, device=dev)
    zbj = torch.zeros(B, dtype=i32, device=dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    rows = torch.zeros(B, dtype=i32, device=dev)

    for i in range(_rows_to_run(qlen, Lq)):
        qi = query[:, i].to(i32)[:, None]
        is_match = (trow == qi) & (trow < 4) & (qi < 4)
        sub = torch.where(is_match, match, -mismatch).to(i32)
        M = h_prev[:, :-1] + sub
        F = torch.maximum(h_prev - (o_ins + e_ins), f_prev - e_ins)
        hnd = torch.cat([torch.maximum(F[:, :1], neg),
                         torch.maximum(M, F[:, 1:])], dim=1)
        if band > 0:
            in_band = (jt - (i + 1)).abs() <= band
            hnd = torch.where(in_band, hnd, neg)
            F = torch.where(in_band, F, neg)
        E = _row_scan_E(hnd, o_del, e_del)
        h = torch.maximum(hnd, E)
        h = torch.where(tmask, h, neg)
        if band > 0:
            h = torch.where(in_band, h, neg)
        active = ((i < qlen[:, 0]) & ~stopped)[:, None]
        rows += active[:, 0]
        h = torch.where(active, h, h_prev)
        f = torch.where(active, F, f_prev)
        hp = torch.where(active & (jt > 0), torch.clamp(h, min=-1), -1)
        hp64 = hp.to(torch.int64)
        best_pack = torch.maximum(best_pack,
                                  ((hp64 + 1) << 32) + (_LOW32 - i))
        g_row = torch.where(active & (i == qlen - 1), h, g_row)
        if zdrop > 0:
            rp = torch.amax(((hp64 + 2) << 32) + (_LOW32 - jt64), dim=-1)
            m = (rp >> 32).to(i32) - 2
            mj = (_LOW32 - (rp & _LOW32)).to(i32)
            act1 = active[:, 0]
            better = m > zbest
            di = i - zbi
            dj = mj - zbj
            gap = (di - dj).abs()
            pen = torch.where(di > dj, e_del, e_ins) * gap
            zstop = act1 & ~better & (zbest - m - pen > zdrop)
            stopped = stopped | zstop | (act1 & (m <= 0))
            upd = act1 & better
            zbest = torch.where(upd, m, zbest).to(i32)
            zbi = torch.where(upd, i, zbi).to(i32)
            zbj = torch.where(upd, mj, zbj).to(i32)
        h_prev, f_prev = h, f

    col_best = best_pack.amax(dim=-1)
    btle = torch.argmax(best_pack, dim=-1).to(i32)
    score = ((col_best >> 32) - 1).to(i32)
    bqle = (_LOW32 - (col_best & _LOW32) + 1).to(i32)
    found = score > 0
    zero = torch.zeros_like(score)
    out = dict(score=torch.where(found, score, zero).to(i32),
               qle=torch.where(found, bqle, zero).to(i32),
               tle=torch.where(found, btle, zero).to(i32),
               gscore=g_row.amax(dim=-1).to(i32),
               gtle=torch.argmax(g_row, dim=-1).to(i32))
    if return_rows:
        out["rows"] = rows
    return out


def extend_rect(query, qlen, target, tlen, h0,
                o_del: int = 6, e_del: int = 1,
                o_ins: int = 6, e_ins: int = 1,
                match: int = 1, mismatch: int = 4,
                zdrop: int = 0, return_rows: bool = False):
    """Full-rectangle extension, the plain version of kernels K3-K5:
    ``extend_batch(band=0)`` with their output convention for a lane
    whose last query row is all dead (gscore <= NEG16): gscore = NEG
    (-2^30) and gtle = 0.  Such a lane is one whose last row is never
    computed (qlen = 0, qlen > Lq, or stopped by z-drop before it); in
    the domain the kernels take (0 <= h0, Lq + Lt < 16000) a computed
    row always has a live column 0, so the rule changes nothing else.
    Shapes as ``check_rect_shape`` takes them."""
    check_rect_shape("extend_rect", query.shape[1], target.shape[1])
    out = extend_batch(query, qlen, target, tlen, h0, o_del=o_del,
                       e_del=e_del, o_ins=o_ins, e_ins=e_ins, match=match,
                       mismatch=mismatch, zdrop=zdrop, band=0,
                       return_rows=return_rows)
    dead = out["gscore"] <= NEG16
    out["gscore"] = torch.where(dead, NEG, out["gscore"]).to(torch.int32)
    out["gtle"] = torch.where(dead, 0, out["gtle"]).to(torch.int32)
    return out


def check_rect_shape(who: str, Lq: int, Lt: int) -> None:
    """The shapes the rectangle extension takes, on every route: Lq <=
    4095 (rows are packed as 4095 - row) and Lt <= RECT_MAX_LT."""
    if Lq > 4095 or not 0 <= Lt <= RECT_MAX_LT:
        raise ValueError(f"{who}: needs Lq <= 4095 and Lt <= {RECT_MAX_LT}")


# local_batch packs (score, row, column) into 9 + 11 + 11 bits of an int32,
# as the JAX package does: shapes under 2048 and scores clamped at 511
LOCAL_MAX_LEN = 2047
LOCAL_MAX_SCORE = 511


def _local_pass(query, qlen, target, tlen, o_del, e_del, o_ins, e_ins,
                match, mismatch):
    """One local Smith-Waterman pass: (score, end row + 1, end column)
    of each lane's best cell (highest score, then the smallest row, then
    the smallest column), zeros where no cell scores above 0."""
    dev = query.device
    i32 = torch.int32
    B, Lq = query.shape
    Lt = target.shape[1]
    jt = torch.arange(Lt + 1, dtype=i32, device=dev)[None, :]
    trow = target.to(i32)
    tmask = (jt <= tlen.to(i32)[:, None]) & (jt > 0)
    qlen = qlen.to(i32)
    h_prev = torch.zeros((B, Lt + 1), dtype=i32, device=dev)
    f_prev = torch.full((B, Lt + 1), NEG, dtype=i32, device=dev)
    neg_col = f_prev[:, :1]
    best = torch.zeros(B, dtype=i32, device=dev)
    for i in range(_rows_to_run(qlen, Lq)):
        qi = query[:, i].to(i32)[:, None]
        is_match = (trow == qi) & (trow < 4) & (qi < 4)
        sub = torch.where(is_match, match, -mismatch).to(i32)
        M = h_prev[:, :-1] + sub
        F = torch.maximum(h_prev - (o_ins + e_ins), f_prev - e_ins)
        hnd = torch.cat([neg_col, torch.maximum(M, F[:, 1:])], dim=1)
        E = _row_scan_E(hnd, o_del, e_del)
        h = torch.clamp(torch.maximum(hnd, E), min=0)
        h = torch.where(tmask, h, 0)
        active = (i < qlen)[:, None]
        h = torch.where(active, h, h_prev)
        f = torch.where(active, F, f_prev)
        hp = torch.clamp(torch.where(active & tmask, h, 0),
                         max=LOCAL_MAX_SCORE)
        pack = (hp << 22) | ((2047 - i) << 11) | (2047 - jt)
        best = torch.maximum(best, pack.amax(dim=1))
        h_prev, f_prev = h, f
    score = best >> 22
    ei = 2047 - ((best >> 11) & 0x7FF)
    ej = 2047 - (best & 0x7FF)
    found = score > 0
    zero = torch.zeros_like(score)
    return (torch.where(found, score, zero), torch.where(found, ei + 1, zero),
            torch.where(found, ej, zero))


def local_batch(query, qlen, target, tlen,
                o_del: int = 6, e_del: int = 1,
                o_ins: int = 6, e_ins: int = 1,
                match: int = 1, mismatch: int = 4):
    """Batched local Smith-Waterman (the role of bwa's ksw_align in mate
    rescue): score and the best local alignment's [qb, qe) x [tb, te).

    A forward pass finds the best end cell; the same DP over the
    reversed prefixes finds the start.  The JAX package's caps hold:
    Lq, Lt <= LOCAL_MAX_LEN (raises otherwise), and a score is clamped
    at LOCAL_MAX_SCORE.  Returns an int32 dict: score, qb, qe, tb, te."""
    B, Lq = query.shape
    Lt = target.shape[1]
    if Lq > LOCAL_MAX_LEN or Lt > LOCAL_MAX_LEN:
        raise ValueError(f"local_batch: needs Lq, Lt <= {LOCAL_MAX_LEN}, "
                         f"got {Lq}, {Lt}")
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              match=match, mismatch=mismatch)
    score, qe, te = _local_pass(query, qlen, target, tlen, **kw)
    dev = query.device
    kq = torch.arange(Lq, device=dev)[None, :]
    qr = query.gather(1, (qe[:, None] - 1 - kq).clamp(0, Lq - 1))
    qr = torch.where(kq < qe[:, None], qr, torch.full_like(qr, 4))
    kt = torch.arange(Lt, device=dev)[None, :]
    tr = target.gather(1, (te[:, None] - 1 - kt).clamp(0, Lt - 1))
    tr = torch.where(kt < te[:, None], tr, torch.full_like(tr, 4))
    _, qspan, tspan = _local_pass(qr, qe, tr, te, **kw)
    return dict(score=score, qb=qe - qspan, qe=qe, tb=te - tspan, te=te)


def global_batch(query, qlen, target, tlen,
                 o_del: int = 6, e_del: int = 1,
                 o_ins: int = 6, e_ins: int = 1,
                 match: int = 1, mismatch: int = 4,
                 band: int = 100):
    """Banded global alignment with direction matrix.

    Returns (score int32 [B], dirs uint8 [B, Lq, Lt+1]); row i of dirs
    holds the H source and gap-extend/mismatch bits of DP row i+1."""
    dev = query.device
    i32 = torch.int32
    B, Lq = query.shape
    Lt = target.shape[1]
    jt = torch.arange(Lt + 1, dtype=i32, device=dev)[None, :]
    tmask = jt <= tlen.to(i32)[:, None]
    trow = target.to(i32)
    with profiling.upload("global_dp.neg"):
        neg = torch.tensor(NEG, dtype=i32, device=dev)
    qlen = qlen.to(i32)

    h = torch.where(jt > 0, -(o_del + e_del * jt), 0).to(i32)
    h = torch.where(tmask, h, neg)
    f = torch.full((B, Lt + 1), NEG, dtype=i32, device=dev)
    dirs = torch.zeros((B, Lq, Lt + 1), dtype=torch.uint8, device=dev)
    neg_col = torch.full((B, 1), NEG, dtype=i32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=torch.uint8, device=dev)

    n_rows = _rows_to_run(qlen, Lq)
    profiling.count("global_dp.dp_rows_run", n_rows)
    for i in range(n_rows):
        qi = query[:, i].to(i32)[:, None]
        is_match = (trow == qi) & (trow < 4) & (qi < 4)
        sub = torch.where(is_match, match, -mismatch).to(i32)
        M = h[:, :-1] + sub
        f_open = h - (o_ins + e_ins)
        f_ext = f - e_ins
        F = torch.maximum(f_open, f_ext)
        fext_bit = (f_ext >= f_open).to(torch.uint8) * BIT_FEXT
        hnd = torch.cat([torch.full_like(neg_col, -(o_ins + e_ins * (i + 1))),
                         torch.maximum(M, F[:, 1:])], dim=1)
        E = _row_scan_E(hnd, o_del, e_del)
        e_prev_ext = torch.cat([neg_col, E[:, :-1] - e_del], dim=1)
        eext_bit = (e_prev_ext >= E).to(torch.uint8) * BIT_EEXT
        hn = torch.maximum(hnd, E)
        m_full = torch.cat([neg_col, M], dim=1)
        src = torch.where(hn == m_full, DIR_M,
                          torch.where(hn == E, DIR_E, DIR_F)).to(torch.uint8)
        src[:, 0] = DIR_F
        mis_bit = torch.cat(
            [zero_col, (~is_match).to(torch.uint8) * BIT_MIS], dim=1)
        dircode = src | eext_bit | fext_bit | mis_bit
        band_ok = (jt - (i + 1)).abs() <= band
        hn = torch.where(tmask & band_ok, hn, neg)
        active = (i < qlen)[:, None]
        h = torch.where(active, hn, h)
        f = torch.where(active, F, f)
        dirs[:, i, :] = torch.where(active, dircode, 0)
    score = h.gather(1, tlen.to(torch.int64).clamp(0, Lt)[:, None])[:, 0]
    return score, dirs
