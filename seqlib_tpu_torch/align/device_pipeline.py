"""Device stages of the alignment pipeline (counterpart of
seqlib_tpu/align/device_pipeline.py).

``seed_chain_extend`` runs the three bwa seeding passes (SMEM machine,
kernel K2), SA locate, chaining, and left/right banded extension of
every kept chain anchor (kernel K1 through the adaptive-band wrapper on
the GPU) plus the tiered per-seed second extension.
``global_and_traceback`` is the banded global DP with an on-device
traceback walk that emits packed op codes and NM counts.

JAX's fixed-shape idioms map as follows: ``.at[].set(mode="drop")`` is
a scatter into one extra sink row, ``lax.cond``/``while_loop`` are
Python branches and loops, ``take_along_axis`` is ``gather``, stable
argsorts are ``torch.sort(stable=True)``.
"""

from __future__ import annotations

import torch

from ..ops.fm import DeviceFMIndex, sa_lookup, smem_collect, smem_reseed
from ..ops.sw import (BIT_EEXT, BIT_FEXT, BIT_MIS, DIR_E, DIR_M,
                      global_batch)
from ..ops.sw_cuda import extend_batch_adaptive

OP_M, OP_D, OP_I, OP_NONE = 0, 1, 2, 3

# per-seed second-extension slots appended to the max_chains region slots
ESC_SLOTS = 3
# sentinel text position: past every position of any index (positions are
# int64 on both the narrow and the wide path)
POS_BIG = 1 << 62

I32 = torch.int32
I64 = torch.int64


def dp_rows(B: int) -> int:
    """Compacted DP-row budget for a batch of B reads."""
    return max(3 * B // 4, 64)


def _compact(values, ok, dest, M, fill):
    """values[k] -> out[dest[k]] where ok[k]; other rows keep ``fill``
    (the ``.at[].set(mode='drop')`` idiom: a sink row M, then cut)."""
    out = torch.full((M + 1,), fill, dtype=values.dtype,
                     device=values.device)
    out[torch.where(ok, dest, M).to(I64)] = values
    return out[:M]


def seed_and_locate(fm: DeviceFMIndex, reads, lens,
                    max_seeds: int = 16, min_seed_len: int = 19,
                    max_occ: int = 500, k_occ: int = 16,
                    split_len: int = 28, split_width: int = 10,
                    max_mem_intv: int = 20, p3_seeds: int = 8):
    """Seed scan (all three bwa passes) + SA locate.

    Returns dict: qbeg, qend [B, S1]; pos [B, S1, K] int64 text positions
    (-1 invalid); rep_cov, occ_clip, seeds_full [B]."""
    B = reads.shape[0]
    dev = reads.device
    p3 = p3_seeds if max_mem_intv > 0 else 0
    seeds = smem_collect(fm, reads, lens, max_seeds=max_seeds,
                         min_seed_len=min_seed_len, p3_seeds=p3,
                         p3_max_intv=max_mem_intv)
    n, sz, il = seeds["n_seeds"], seeds["intv_sz"], seeds["intv_l"]
    qb_s, qe_s = seeds["qbeg"], seeds["qend"]
    in_range = torch.arange(max_seeds, device=dev)[None, :] < n[:, None]
    repetitive = in_range & (sz > max_occ)
    seed_valid = in_range & (sz > 0) & (sz <= max_occ)

    seed_len = qe_s - qb_s
    qualifies = seed_valid & (seed_len >= split_len) & (sz <= split_width)
    pick = torch.argmax(torch.where(qualifies, seed_len, -1), dim=1)[:, None]

    def at(x):
        return x.gather(1, pick)[:, 0]

    r_qb, r_qe, r_il, r_sz = smem_reseed(
        fm, reads, lens, at(qb_s), at(qe_s), at(sz), at(qualifies),
        min_seed_len=min_seed_len)
    qb_all = torch.cat([qb_s, r_qb[:, None]], dim=1)
    qe_all = torch.cat([qe_s, r_qe[:, None]], dim=1)
    sz_all = torch.cat([sz, r_sz[:, None]], dim=1)
    il_all = torch.cat([il, r_il[:, None]], dim=1)
    valid_all = torch.cat(
        [seed_valid, ((r_sz > 0) & (r_sz <= max_occ))[:, None]], dim=1)
    if p3:
        p3_valid = (torch.arange(p3, device=dev)[None, :]
                    < seeds["p3_n"][:, None]) \
            & (seeds["p3_intv_sz"] > 0) & (seeds["p3_intv_sz"] <= max_occ)
        qb_all = torch.cat([qb_all, seeds["p3_qbeg"]], dim=1)
        qe_all = torch.cat([qe_all, seeds["p3_qend"]], dim=1)
        sz_all = torch.cat([sz_all, seeds["p3_intv_sz"]], dim=1)
        il_all = torch.cat([il_all, seeds["p3_intv_l"]], dim=1)
        valid_all = torch.cat([valid_all, p3_valid], dim=1)

    kk = torch.arange(k_occ, device=dev)[None, None, :]
    k_take = torch.clamp(sz_all, max=k_occ)
    ranks = il_all[:, :, None].to(I64) + kk
    occ_valid = valid_all[:, :, None] & (kk < k_take[:, :, None])
    ranks = torch.where(occ_valid, ranks, -1)
    pos = sa_lookup(fm, ranks)
    rep_cov = torch.where(repetitive, qe_s - qb_s, 0).sum(dim=1)
    occ_clip = torch.where(valid_all, torch.clamp(sz_all - k_occ, min=0),
                           0).sum(dim=1)
    seeds_full = (seeds["n_dropped"] > 0).to(I32)
    return dict(qbeg=qb_all, qend=qe_all, pos=pos, rep_cov=rep_cov,
                occ_clip=occ_clip, seeds_full=seeds_full)


def _stable_order(*keys):
    """Stable lexicographic sort order over [B, N] keys (most
    significant first)."""
    order = None
    for key in reversed(keys):
        k = key if order is None else key.gather(1, order)
        o2 = torch.sort(k, dim=1, stable=True).indices
        order = o2 if order is None else order.gather(1, o2)
    return order


def chain_device(qb_all, qe_all, pos, l_pac: int, band: int = 100,
                 max_chain_gap: int = 10000, drop_ratio: float = 0.5,
                 max_chains: int = 4, min_chain_weight: int = 0,
                 max_chain_extend: int = 1 << 30):
    """Seed chaining (bwa mem_chain): group located occurrences into
    colinear chains by (strand, diagonal within band, proximity), score
    each by bounded coverage, keep each read's top chains per the
    drop_ratio rule.  Requires reads < 1024 bp and S*K <= 512.

    Returns [B, C] anchor_q, anchor_len, anchor_r, weight, keep and
    n_seg [B]."""
    B, S, K = pos.shape
    N = S * K
    dev = pos.device
    oqb = qb_all[:, :, None].expand(B, S, K).reshape(B, N).to(I64)
    oqe = qe_all[:, :, None].expand(B, S, K).reshape(B, N).to(I64)
    opos = pos.reshape(B, N).to(I64)
    olen = oqe - oqb
    ovalid = (opos >= 0) & ~((opos < l_pac) & (opos + olen > l_pac))
    strand = torch.where(ovalid, (opos >= l_pac).to(I64), 3)
    diag = torch.where(ovalid, opos - oqb, 0)
    spos = torch.where(ovalid, opos, POS_BIG)
    order = _stable_order(strand, diag, spos)
    s_strand = strand.gather(1, order)
    s_diag = diag.gather(1, order)
    s_pos = spos.gather(1, order)
    s_qb = oqb.gather(1, order)
    s_len = olen.gather(1, order)
    s_valid = s_strand != 3

    brk = torch.ones((B, N), dtype=torch.bool, device=dev)
    brk[:, 1:] = (s_strand[:, 1:] != s_strand[:, :-1]) \
        | (s_diag[:, 1:] - s_diag[:, :-1] > band) \
        | (s_pos[:, 1:] - s_pos[:, :-1] > max_chain_gap)
    BIG = 2**30
    n_idx = torch.arange(N, device=dev)[None, :].expand(B, N)
    # per-segment aggregates (segments are contiguous in sort order);
    # only the value at a segment's last element is ever used
    seg = torch.cumsum(brk.to(I64), dim=1) - 1 \
        + torch.arange(B, device=dev)[:, None] * N
    seg = seg.reshape(-1)

    def agg(vals, reduce, init):
        out = torch.full((B * N,), init, dtype=I64, device=dev)
        out.scatter_reduce_(0, seg, vals.reshape(-1), reduce=reduce)
        return out[seg].reshape(B, N)

    len_sum = agg(torch.where(s_valid, s_len, 0), "sum", 0)
    qb_min = agg(torch.where(s_valid, s_qb, BIG), "amin", BIG)
    qe_max = agg(torch.where(s_valid, s_qb + s_len, -1), "amax", -1)
    rb_min = agg(torch.where(s_valid, s_pos, POS_BIG), "amin", POS_BIG)
    re_max = agg(torch.where(s_valid, s_pos + s_len, -1), "amax", -1)
    anchor = agg(torch.where(
        s_valid, (s_len << 19) | ((1023 - s_qb) << 9) | (511 - n_idx), -1),
        "amax", -1)
    is_last = torch.cat([brk[:, 1:], torch.ones((B, 1), dtype=torch.bool,
                                                device=dev)], dim=1)
    weight = torch.minimum(len_sum, torch.minimum(qe_max - qb_min,
                                                  re_max - rb_min))
    weight = torch.where(is_last & (anchor >= 0), weight, -1)

    n_seg = (weight >= 0).sum(dim=1).to(I32)
    pk = torch.where(weight >= 0, weight * 512 + (511 - n_idx), -1)
    top = torch.sort(pk, dim=1, descending=True, stable=True
                     ).indices[:, :max_chains]
    w_c = weight.gather(1, top)
    best_w = w_c[:, :1]
    keep = (w_c > 0) & (w_c.to(torch.float32)
                        >= drop_ratio * best_w.to(torch.float32))
    if min_chain_weight > 0:
        keep = keep & (w_c >= min_chain_weight)
    if max_chain_extend < max_chains:
        keep = keep & (torch.arange(max_chains, device=dev)[None, :]
                       < max_chain_extend)
    packed = anchor.gather(1, top)
    a_len = packed >> 19
    a_qb = 1023 - ((packed >> 9) & 1023)
    a_n = 511 - (packed & 511)
    a_pos = s_pos.gather(1, a_n)
    z = torch.zeros_like(a_len)
    return dict(anchor_q=torch.where(keep, a_qb, z).to(I32),
                anchor_len=torch.where(keep, a_len, z).to(I32),
                anchor_r=torch.where(keep, a_pos, z),
                weight=torch.where(keep, w_c, z).to(I32), keep=keep,
                n_seg=n_seg)


def seed_chain_extend(fm: DeviceFMIndex, text, reads, lens,
                      l_pac: int,
                      max_seeds: int = 16, min_seed_len: int = 19,
                      max_occ: int = 500, k_occ: int = 16,
                      band: int = 100, max_chain_gap: int = 10000,
                      drop_ratio: float = 0.5, max_chains: int = 4,
                      o_del: int = 6, e_del: int = 1, o_ins: int = 6,
                      e_ins: int = 1, match: int = 1, mismatch: int = 4,
                      pen_clip5: int = 5, pen_clip3: int = 5,
                      w: int = 100, zdrop: int = 0,
                      split_len: int = 28, split_width: int = 10,
                      min_chain_weight: int = 0,
                      max_chain_extend: int = 1 << 30,
                      max_mem_intv: int = 20):
    """Seed scan + SA locate + chaining + left/right extension.

    Returns dict: qb, qe, rb, re, score, weight [B, C+ESC_SLOTS]; keep;
    anchor_q/len/r; rep_cov, occ_clip, seeds_full, n_seg, esc_over [B];
    n_dp (int: non-trivial chains wanting a DP row)."""
    B, L = reads.shape
    dev = reads.device
    s1 = seed_and_locate(fm, reads, lens, max_seeds=max_seeds,
                         min_seed_len=min_seed_len, max_occ=max_occ,
                         k_occ=k_occ, split_len=split_len,
                         split_width=split_width,
                         max_mem_intv=max_mem_intv)
    ch = chain_device(s1["qbeg"], s1["qend"], s1["pos"], l_pac,
                      band=band, max_chain_gap=max_chain_gap,
                      drop_ratio=drop_ratio, max_chains=max_chains,
                      min_chain_weight=min_chain_weight,
                      max_chain_extend=max_chain_extend)
    C = max_chains
    keep = ch["keep"]
    aq, alen, ar = ch["anchor_q"], ch["anchor_len"], ch["anchor_r"]
    ext_kw = dict(l_pac=l_pac, o_del=o_del, e_del=e_del, o_ins=o_ins,
                  e_ins=e_ins, match=match, mismatch=mismatch,
                  pen_clip5=pen_clip5, pen_clip3=pen_clip3, w=w,
                  zdrop=zdrop)

    # DP compaction: a chain whose anchor covers the whole read is
    # trivial (its extension result is the anchor itself)
    trivial = keep & (aq == 0) & (alen == lens.to(I32)[:, None])
    need = (keep & ~trivial).reshape(-1)
    dest = torch.cumsum(need.to(I64), dim=0) - 1
    n_dp = int(need.sum())
    M2 = dp_rows(B)
    ok = need & (dest < M2)
    src_b = torch.arange(B, device=dev)[:, None].expand(B, C).reshape(-1)
    cb = _compact(src_b.to(I32), ok, dest, M2, -1)
    caq = _compact(aq.reshape(-1), ok, dest, M2, 0)
    calen = _compact(alen.reshape(-1), ok, dest, M2, 0)
    car = _compact(ar.reshape(-1), ok, dest, M2, 0)
    dqb, dqe, drb, dre, dscore = extend_chains(
        text, reads, lens, cb, caq, calen, car, **ext_kw)

    gidx = dest.clamp(0, M2 - 1)
    okg = ok.reshape(B, C)

    def pick(dp, triv_val):
        v = dp[gidx].reshape(B, C).to(I64)
        return torch.where(trivial, triv_val.to(I64),
                           torch.where(okg, v, 0))

    qb = pick(dqb, aq)
    qe = pick(dqe, aq + alen)
    rb = pick(drb, ar)
    re = pick(dre, ar + alen)
    score = pick(dscore, alen * match)

    # ---- mem_chain2aln's per-seed loop: up to ESC_SLOTS extra
    # extensions per read from located seeds of the best region's
    # chain that escape its query x ref span
    bsel = torch.argmax(torch.where(keep, score, -1), dim=1)[:, None]

    def col(x):
        return x.gather(1, bsel)[:, 0]

    qb1, qe1 = col(qb), col(qe)
    rb1, re1 = col(rb), col(re)
    diag1 = col(ar) - col(aq)
    has_best = (keep & (score > 0)).any(dim=1)
    qbs, qes = s1["qbeg"].to(I64), s1["qend"].to(I64)
    posg = s1["pos"]
    S1, K = posg.shape[1], posg.shape[2]
    S1k = S1 * K
    olen3 = (qes - qbs)[:, :, None]
    same_half = (posg >= l_pac) == (rb1[:, None, None] >= l_pac)
    candv = (posg >= 0) & (olen3 > 0) & same_half \
        & ((posg - qbs[:, :, None] - diag1[:, None, None]).abs() <= w) \
        & ~((posg < l_pac) & (posg + olen3 > l_pac))
    contained = (qbs[:, :, None] >= qb1[:, None, None]) \
        & (qes[:, :, None] <= qe1[:, None, None]) \
        & (posg >= rb1[:, None, None]) \
        & (posg + olen3 <= re1[:, None, None])
    esc = candv & ~contained & has_best[:, None, None]
    escf = esc.reshape(B, S1k)
    olenf = olen3.expand(B, S1, K).reshape(B, S1k)
    qbf = qbs[:, :, None].expand(B, S1, K).reshape(B, S1k)
    posf = posg.reshape(B, S1k)
    pk_cur = torch.where(escf, (olenf << 10) | (1023 - qbf), 0)
    E = ESC_SLOTS
    cand_has, cand_aq, cand_alen, cand_ar = [], [], [], []
    for _ in range(E):
        jx = torch.argmax(pk_cur, dim=1)[:, None]
        h_e = pk_cur.gather(1, jx)[:, 0] > 0
        aq_e = qbf.gather(1, jx)[:, 0]
        cand_has.append(h_e)
        cand_aq.append(torch.where(h_e, aq_e, 0))
        cand_alen.append(torch.where(h_e, olenf.gather(1, jx)[:, 0], 0))
        cand_ar.append(torch.where(h_e, posf.gather(1, jx)[:, 0], 0))
        pk_cur = torch.where(qbf == aq_e[:, None], 0, pk_cur)
    left_over = (pk_cur > 0).any(dim=1)
    hasx = torch.stack(cand_has, dim=1)
    x_aq = torch.stack(cand_aq, dim=1)
    x_alen = torch.stack(cand_alen, dim=1)
    x_ar = torch.stack(cand_ar, dim=1)
    hf = hasx.reshape(-1)
    dstx = torch.cumsum(hf.to(I64), dim=0) - 1
    n_hf = int(hf.sum())
    src_be = torch.arange(B, device=dev)[:, None].expand(B, E).reshape(-1)
    # tiered second extension: a small compacted pass (B/16 rows) for
    # typical batches, a B-row pass for repeat-heavy ones
    M3a = max(B // 16, 64)
    M3b = max(B, 64)
    use_small = n_hf <= M3a
    M3 = M3a if use_small else M3b
    okx = hf & (dstx < M3)
    if bool(okx.any()):
        res = extend_chains(
            text, reads, lens, _compact(src_be.to(I32), okx, dstx, M3, -1),
            _compact(x_aq.reshape(-1).to(I32), okx, dstx, M3, 0),
            _compact(x_alen.reshape(-1).to(I32), okx, dstx, M3, 0),
            _compact(x_ar.reshape(-1), okx, dstx, M3, 0), **ext_kw)
    else:
        res = (torch.zeros(M3, dtype=I64, device=dev),) * 5
    gx = dstx.clamp(0, M3 - 1)
    okg2 = okx.reshape(B, E)

    def back(i):
        v = res[i].to(I64)[gx].reshape(B, E)
        return torch.where(okg2, v, 0)

    esc_over = (hf & ~okx).reshape(B, E).sum(dim=1) + left_over.to(I64)
    return dict(
        qb=torch.cat([qb, back(0)], dim=1),
        qe=torch.cat([qe, back(1)], dim=1),
        rb=torch.cat([rb, back(2)], dim=1),
        re=torch.cat([re, back(3)], dim=1),
        score=torch.cat([score, back(4)], dim=1),
        weight=torch.cat([ch["weight"].to(I64),
                          torch.where(okg2, x_alen, 0)], dim=1),
        keep=torch.cat([keep, okg2], dim=1),
        anchor_q=torch.cat([aq.to(I64), torch.where(okg2, x_aq, 0)], dim=1),
        anchor_len=torch.cat([alen.to(I64), torch.where(okg2, x_alen, 0)],
                             dim=1),
        anchor_r=torch.cat([ar.to(I64), torch.where(okg2, x_ar, 0)], dim=1),
        rep_cov=s1["rep_cov"], n_dp=n_dp, occ_clip=s1["occ_clip"],
        seeds_full=s1["seeds_full"], n_seg=ch["n_seg"], esc_over=esc_over)


def extend_chains(text, reads, lens, b_idx, aq, alen, ar,
                  l_pac: int,
                  o_del: int = 6, e_del: int = 1, o_ins: int = 6,
                  e_ins: int = 1, match: int = 1, mismatch: int = 4,
                  pen_clip5: int = 5, pen_clip3: int = 5, w: int = 100,
                  zdrop: int = 0):
    """Left + right extension of M chain anchors with bwa's soft-clip
    decisions.  b_idx/aq/alen/ar [M] (b_idx = -1 pads).  Returns int64
    (qb, qe, rb, re, score) [M]."""
    B, L = reads.shape
    dev = reads.device
    TW = L + w + 1
    b_idx, aq, alen, ar = (v.to(I64) for v in (b_idx, aq, alen, ar))
    valid = b_idx >= 0
    bsafe = b_idx.clamp(min=0)
    rlens = lens.to(I64)[bsafe]
    rows = reads[bsafe]
    jr = torch.arange(L, device=dev)[None, :]
    jt = torch.arange(TW, device=dev)[None, :]
    n_text = text.shape[0]
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              match=match, mismatch=mismatch, zdrop=zdrop)
    four = torch.tensor(4, dtype=torch.int8, device=dev)

    # ---- left: reversed prefixes ------------------------------------
    lq = torch.where(valid, aq, 0)
    q_l = rows.gather(1, (aq[:, None] - 1 - jr).clamp(0, L - 1))
    q_l = torch.where(jr < lq[:, None], q_l.to(torch.int8), four)
    floor = torch.where(ar >= l_pac, l_pac, 0)
    wl = torch.minimum(aq + w, ar - floor)
    wl = torch.where(valid, wl.clamp(min=0), 0)
    t_l = text[(ar[:, None] - 1 - jt).clamp(0, n_text - 1)]
    t_l = torch.where(jt < wl[:, None], t_l.to(torch.int8), four)
    h0 = alen * match
    out_l = extend_batch_adaptive(q_l, lq, t_l, wl, h0, band=w, **kw)
    sc_l, qle_l, tle_l, gs_l, gt_l = (out_l[k].to(I64) for k in
                                      ("score", "qle", "tle", "gscore",
                                       "gtle"))
    no_left = lq == 0
    ext_l = sc_l > h0
    loc_l = torch.maximum(sc_l, h0)
    use_gl = (gs_l > 0) & (gs_l > loc_l - pen_clip5)
    qb = torch.where(no_left, aq, torch.where(
        use_gl, 0, torch.where(ext_l, aq - qle_l, aq)))
    rb = torch.where(no_left, ar, torch.where(
        use_gl, ar - gt_l, torch.where(ext_l, ar - tle_l, ar)))
    score_l = torch.where(no_left, h0, torch.where(use_gl, gs_l, loc_l))

    # ---- right --------------------------------------------------------
    qstart = aq + alen
    rstart = ar + alen
    rlen = torch.where(valid, rlens - qstart, 0).clamp(min=0)
    q_r = rows.gather(1, (qstart[:, None] + jr).clamp(0, L - 1))
    q_r = torch.where(jr < rlen[:, None], q_r.to(torch.int8), four)
    ceil = torch.where(ar < l_pac, l_pac, 2 * l_pac)
    wr = torch.minimum(rlen + w, ceil - rstart)
    wr = torch.where(valid, wr.clamp(min=0), 0)
    t_r = text[(rstart[:, None] + jt).clamp(0, n_text - 1)]
    t_r = torch.where(jt < wr[:, None], t_r.to(torch.int8), four)
    out_r = extend_batch_adaptive(q_r, rlen, t_r, wr, score_l, band=w, **kw)
    sc_r, qle_r, tle_r, gs_r, gt_r = (out_r[k].to(I64) for k in
                                      ("score", "qle", "tle", "gscore",
                                       "gtle"))
    no_right = rlen == 0
    ext_r = sc_r > score_l
    loc_r = torch.maximum(sc_r, score_l)
    use_gr = (gs_r > 0) & (gs_r > loc_r - pen_clip3)
    qe = torch.where(no_right, qstart, torch.where(
        use_gr, rlens, torch.where(ext_r, qstart + qle_r, qstart)))
    re = torch.where(no_right, rstart, torch.where(
        use_gr, rstart + gt_r, torch.where(ext_r, rstart + tle_r, rstart)))
    score = torch.where(no_right, score_l,
                        torch.where(use_gr, gs_r, loc_r))
    return qb, qe, rb, re, score


def global_and_traceback(q, ql, t, tl,
                         o_del: int = 6, e_del: int = 1, o_ins: int = 6,
                         e_ins: int = 1, match: int = 1, mismatch: int = 4,
                         band: int = 208):
    """Banded global DP + on-device traceback.

    Returns (score int32 [M], packed uint8 [M, Tp/4] step codes in
    reverse walk order, 4 per byte at bits 0/2/4/6 with OP_NONE
    padding, nm int32 [M]); the direction matrix stays on the device."""
    M, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    score, dirs = global_batch(q, ql, t, tl, o_del=o_del, e_del=e_del,
                               o_ins=o_ins, e_ins=e_ins, match=match,
                               mismatch=mismatch, band=band)
    dirs_flat = dirs.reshape(M, Lq * (Lt + 1))
    T = (2 * (Lq + Lt) + 7) // 4 * 4
    Tp = (T + 3) // 4 * 4
    ops = torch.full((M, Tp), OP_NONE, dtype=torch.uint8, device=dev)
    i = ql.to(I64).clone()
    j = tl.to(I64).clone()
    state = torch.zeros(M, dtype=I64, device=dev)
    nm = torch.zeros(M, dtype=I64, device=dev)
    for s in range(T):
        # the walk is over once every row has reached (0, 0)
        if s % 8 == 0 and not bool(((i > 0) | (j > 0)).any()):
            break
        done = (i == 0) & (j == 0)
        code = dirs_flat.gather(
            1, ((i - 1).clamp(0, Lq - 1) * (Lt + 1)
                + j.clamp(0, Lt))[:, None])[:, 0].to(I64)
        at_top = (i == 0) & (j > 0)
        at_left = (j == 0) & (i > 0)
        src = code & 3
        h_is_m = (state == 0) & (src == DIR_M)
        h_to_e = (state == 0) & (src == DIR_E)
        h_to_f = (state == 0) & (src > DIR_E)
        in_e = state == 1
        in_f = state == 2
        op = torch.where(done, OP_NONE,
             torch.where(at_top, OP_D,
             torch.where(at_left, OP_I,
             torch.where(h_is_m, OP_M,
             torch.where(in_e, OP_D,
             torch.where(in_f, OP_I, OP_NONE))))))
        is_m, is_d, is_i = op == OP_M, op == OP_D, op == OP_I
        nm = nm + torch.where(is_m, ((code & BIT_MIS) != 0).to(I64),
                              (is_d | is_i).to(I64))
        state = torch.where(done | at_top | at_left, state,
                torch.where(h_to_e, 1,
                torch.where(h_to_f, 2,
                torch.where(in_e & ((code & BIT_EEXT) == 0), 0,
                torch.where(in_f & ((code & BIT_FEXT) == 0), 0,
                torch.where(h_is_m, 0, state))))))
        ops[:, s] = op.to(torch.uint8)
        i = i - (is_m | is_i).to(I64)
        j = j - (is_m | is_d).to(I64)
    o4 = ops.reshape(M, Tp // 4, 4)
    packed = o4[..., 0] | (o4[..., 1] << 2) | (o4[..., 2] << 4) \
        | (o4[..., 3] << 6)
    return score.to(I32), packed, nm.to(I32)


def global_and_traceback_packed(q, ql, t, tl, **kw):
    """global_and_traceback with (score, nm) stacked into one [M, 2]."""
    score, packed, nm = global_and_traceback(q, ql, t, tl, **kw)
    return torch.stack([score, nm], dim=1), packed
