"""The whole per-batch device program (counterpart of
seqlib_tpu/align/device_full.py).

``align_full`` runs seed scan, SA locate, chaining and extension
(``seed_chain_extend``), then bwa's ``mem_sort_dedup_patch`` and
``mem_mark_primary_se`` on the device, compacts the live regions into
global-DP rows and runs the banded global DP with its traceback.  The
host keeps only float64 MAPQ, T filtering, contig resolution and
record emission.

One program serves narrow and wide indexes: positions are int64
throughout, and the region block comes back int32 on a narrow index and
int64 on a wide one (``fm.wide``), in the same 10-field layout, so the
host reads both through one path (the JAX package's wide twin,
``device_full_wide.py``, splits rb/re into hi/lo planes instead).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import profiling
from .device_pipeline import POS_BIG, dp_rows, dp_widths, \
    global_and_traceback, seed_chain_extend

# field indices of the per-region output block
F_QB, F_QE, F_RB, F_RE, F_SCORE, F_SUB, F_SUBN, F_SEC, F_FLAGS, \
    F_DPROW = range(10)
NFIELD = 10
FLAG_EMIT = 1          # valid, non-dup region
FLAG_WIDE = 2          # span exceeds the narrow DP window (host path)
FLAG_OVER = 4          # no DP slot left (host path)
FLAG_PERFECT = 8       # exact match: CIGAR = one M run, NM 0

_M64 = (1 << 64) - 1
I32 = torch.int32
I64 = torch.int64


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


def _resort(order, key):
    """Refine ``order`` by a more significant stable sort key."""
    k = key.gather(1, order)
    return order.gather(1, torch.sort(k, dim=1, stable=True).indices)


def _dedup_walk_order(score, rb, qb, re, valid):
    """Per-read dedup walk order (-score, rb, qb, re), invalid last."""
    BIG = 0x3FFFFFFF
    order = torch.sort(torch.where(valid, re, POS_BIG), dim=1,
                       stable=True).indices
    order = _resort(order, torch.where(valid, qb, BIG))
    order = _resort(order, torch.where(valid, rb, POS_BIG))
    order = _resort(order, torch.where(valid, -score, BIG))
    return order


def _mark_walk_order(score, live):
    """Primary-marking order: score desc, ties by hash_64 of the
    region's rank among the post-dedup survivors."""
    BIG = 0x3FFFFFFF
    C = score.shape[1]
    rank = torch.cumsum(live.to(I64), dim=1) - 1
    hashes = np.array([_hash64(i) for i in range(C)], dtype=np.uint64)
    with profiling.upload("hash_rank"):
        hrank = torch.as_tensor(
            np.argsort(np.argsort(hashes)).astype(np.int64),
            device=score.device)
    k_tie = torch.where(live, hrank[rank.clamp(0, C - 1)], BIG)
    order = torch.sort(k_tie, dim=1, stable=True).indices
    return _resort(order, torch.where(live, -score, BIG))


def align_full(fm, text, enc_lens, l_pac: int,
               max_seeds: int = 16, min_seed_len: int = 19,
               max_occ: int = 500, k_occ: int = 16,
               band: int = 100, max_chain_gap: int = 10000,
               drop_ratio: float = 0.5, max_chains: int = 4,
               o_del: int = 6, e_del: int = 1, o_ins: int = 6,
               e_ins: int = 1, match: int = 1, mismatch: int = 4,
               pen_clip5: int = 5, pen_clip3: int = 5, w: int = 100,
               zdrop: int = 0, T: int = 30,
               mask_level: float = 0.5, mask_level_redun: float = 0.95,
               glob_band: int = 208,
               split_len: int = 28, split_width: int = 10,
               min_chain_weight: int = 0,
               max_chain_extend: int = 1 << 30,
               max_mem_intv: int = 20):
    """enc_lens: uint8 [B, L+4] — nt4 codes with the read length packed
    little-endian into the last 4 columns.

    Returns (regions [B, S*NFIELD + 8] with S = max_chains + ESC_SLOTS
    region slots, int32 on a narrow index and int64 on a wide one, snm
    int32 [M2, 2], run_off int64 [M2 + 1], runs int32): DP row d's CIGAR
    runs are ``runs[run_off[d]:run_off[d + 1]]`` (``global_and_traceback``'s
    words; rows past the batch's live ones have none), and ``runs`` holds
    ``run_off[M2]`` of them and room past."""
    B = enc_lens.shape[0]
    L = enc_lens.shape[1] - 4
    dev = enc_lens.device
    reads = enc_lens[:, :L]
    lb = enc_lens[:, L:].to(I64)
    lens = lb[:, 0] | (lb[:, 1] << 8) | (lb[:, 2] << 16) | (lb[:, 3] << 24)

    out = seed_chain_extend(
        fm, text, reads, lens, l_pac=l_pac, max_seeds=max_seeds,
        min_seed_len=min_seed_len, max_occ=max_occ, k_occ=k_occ,
        band=band, max_chain_gap=max_chain_gap, drop_ratio=drop_ratio,
        max_chains=max_chains, o_del=o_del, e_del=e_del, o_ins=o_ins,
        e_ins=e_ins, match=match, mismatch=mismatch,
        pen_clip5=pen_clip5, pen_clip3=pen_clip3, w=w, zdrop=zdrop,
        split_len=split_len, split_width=split_width,
        min_chain_weight=min_chain_weight,
        max_chain_extend=max_chain_extend, max_mem_intv=max_mem_intv)
    with profiling.span("dedup_mark", device=dev):
        C = out["keep"].shape[1]
        order1 = _dedup_walk_order(out["score"], out["rb"], out["qb"],
                                   out["re"], out["keep"])

        def pick(x, order):
            return x.gather(1, order)

        qb, qe = pick(out["qb"], order1), pick(out["qe"], order1)
        rb, re = pick(out["rb"], order1), pick(out["re"], order1)
        score = pick(out["score"], order1)
        valid = pick(out["keep"], order1)

        # ---- mem_sort_dedup_patch -------------------------------------
        dup = torch.zeros((B, C), dtype=torch.bool, device=dev)
        for j in range(1, C):
            dj = torch.zeros(B, dtype=torch.bool, device=dev)
            for i in range(j):
                inter = torch.minimum(re[:, i], re[:, j]) \
                    - torch.maximum(rb[:, i], rb[:, j])
                minw = torch.minimum(re[:, i] - rb[:, i],
                                     re[:, j] - rb[:, j])
                qover = torch.minimum(qe[:, i], qe[:, j]) \
                    - torch.maximum(qb[:, i], qb[:, j])
                o = (inter > 0) & (inter.to(torch.float32)
                                   >= mask_level_redun
                                   * minw.to(torch.float32)) & (qover > 0)
                dj = dj | (valid[:, i] & ~dup[:, i] & o)
            dup[:, j] = dup[:, j] | (valid[:, j] & dj)

        order2 = _mark_walk_order(score, valid & ~dup)
        qb, qe = pick(qb, order2), pick(qe, order2)
        rb, re = pick(rb, order2), pick(re, order2)
        score = pick(score, order2)
        live_m = pick(valid & ~dup, order2)

        # ---- mem_mark_primary_se --------------------------------------
        sub_tmp = max(match + mismatch, o_del + e_del, o_ins + e_ins)
        sec = [torch.full((B,), -1, dtype=I64, device=dev) for _ in range(C)]
        sub = [torch.zeros(B, dtype=I64, device=dev) for _ in range(C)]
        subn = [torch.zeros(B, dtype=I64, device=dev) for _ in range(C)]
        live = [live_m[:, j] for j in range(C)]
        for j in range(1, C):
            placed = torch.zeros(B, dtype=torch.bool, device=dev)
            for i in range(j):
                emin = torch.minimum(qe[:, i], qe[:, j])
                bmax = torch.maximum(qb[:, i], qb[:, j])
                minl = torch.minimum(qe[:, i] - qb[:, i],
                                     qe[:, j] - qb[:, j])
                ov = (emin > bmax) & ((emin - bmax).to(torch.float32)
                                      >= mask_level * minl.to(torch.float32))
                hit = live[j] & live[i] & (sec[i] == -1) & ov & ~placed
                sec[j] = torch.where(hit, i, sec[j])
                sub[i] = torch.where(hit & (sub[i] == 0), score[:, j],
                                     sub[i])
                subn[i] = torch.where(
                    hit & (score[:, i] - score[:, j] <= sub_tmp),
                    subn[i] + 1, subn[i])
                placed = placed | hit
        sec_a = torch.stack(sec, dim=1)
        sub_a = torch.stack(sub, dim=1)
        subn_a = torch.stack(subn, dim=1)
        live_a = torch.stack(live, dim=1)

    # ---- global-DP row compaction ------------------------------------
    with profiling.span("global_dp", device=dev):
        Lt, _ = dp_widths(L, w)
        span_t = re - rb
        span_q = qe - qb
        wide = live_a & ((span_t > Lt) | (span_q > L))
        perfect = live_a & (score == span_q * match) & (span_t == span_q)
        need = (live_a & ~wide & ~perfect & (score >= T)).reshape(-1)
        dest = torch.cumsum(need.to(I64), dim=0) - 1
        M2 = dp_rows(B)
        over = need & (dest >= M2)
        used = need & ~over
        with profiling.sync("global_dp.rows"):
            g_n = int(used.sum())
        profiling.count("global_dp.rows", g_n)
        # rows [g_n, M2) are empty (ql = tl = 0): their DP result is the
        # trivial one (score 0, NM 0, no runs), so only g_n rows run
        with profiling.sync("global_dp.nonzero"):
            rows = torch.nonzero(used).flatten()
        g_b = torch.div(rows, C, rounding_mode="floor")
        g_qb = qb.reshape(-1)[rows]
        g_qe = qe.reshape(-1)[rows]
        g_rb = rb.reshape(-1)[rows]
        g_re = re.reshape(-1)[rows]
        jq = torch.arange(L, device=dev)[None, :]
        ql_g = g_qe - g_qb
        qwin = reads[g_b].gather(1, (g_qb[:, None] + jq).clamp(0, L - 1))
        qwin = torch.where(jq < ql_g[:, None], qwin, 4).to(torch.uint8)
        jt = torch.arange(Lt, device=dev)[None, :]
        tl_g = g_re - g_rb
        twin = text[(g_rb[:, None] + jt).clamp(0, text.shape[0] - 1)]
        twin = torch.where(jt < tl_g[:, None], twin, 4).to(torch.uint8)
        gscore, nm, run_off, runs = global_and_traceback(
            qwin, ql_g, twin, tl_g, o_del=o_del, e_del=e_del, o_ins=o_ins,
            e_ins=e_ins, match=match, mismatch=mismatch, band=glob_band)
        snm = torch.zeros((M2, 2), dtype=I32, device=dev)
        snm[:g_n, 0] = gscore
        snm[:g_n, 1] = nm
        run_off = torch.cat([run_off, run_off[-1:].expand(M2 - g_n)])

    # ---- packed per-region output ------------------------------------
    with profiling.span("pack", device=dev):
        flags = (live_a.to(I64) * FLAG_EMIT
                 | wide.to(I64) * FLAG_WIDE
                 | over.reshape(B, C).to(I64) * FLAG_OVER
                 | perfect.to(I64) * FLAG_PERFECT)
        dprow = torch.where(used.reshape(B, C), dest.reshape(B, C), -1)
        fields = torch.stack([qb, qe, rb, re, score, sub_a, subn_a, sec_a,
                              flags, dprow], dim=2)
        extra = torch.stack([
            out["rep_cov"].to(I64),
            live_a.sum(dim=1),
            out["occ_clip"].to(I64),
            out["seeds_full"].to(I64),
            out["n_seg"].to(I64),
            torch.full((B,), g_n, dtype=I64, device=dev),
            torch.full((B,), out["n_dp"], dtype=I64, device=dev),
            out["esc_over"].to(I64)], dim=1)
        regions = torch.cat([fields.reshape(B, C * NFIELD), extra], dim=1)
        return regions.to(I64 if fm.wide else I32), snm, run_off, runs
