"""Host seed chaining (counterpart of seqlib_tpu/align/chain.py):
``chain_batch`` for the long-read path, and the per-read
``chain_seeds`` / ``filter_chains`` of the library surface.

Seed occurrences (query begin/end, text position in 2L space) are
grouped into colinear chains in int64 numpy, with no length caps: the
fused device path packs chain sort keys into 10-bit query fields, which
caps its reads at 1024 bp, so longer reads are chained here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Chain:
    """A colinear group of seed occurrences (all in 2L text space)."""
    qbeg: int
    qend: int
    rbeg: int
    rend: int
    seeds: list[tuple[int, int, int]] = field(default_factory=list)
    # each seed: (qbeg, len, rbeg)

    @property
    def weight(self) -> int:
        """Query coverage by seeds (approximation of mem_chain_weight)."""
        ivs = sorted((q, q + l) for q, l, _ in self.seeds)
        tot, last = 0, -1
        for s, e in ivs:
            s = max(s, last)
            if e > s:
                tot += e - s
                last = e
        return tot

    @property
    def anchor(self) -> tuple[int, int, int]:
        """Longest seed (ties: leftmost)."""
        return max(self.seeds, key=lambda s: (s[1], -s[0]))


def chain_seeds(occs: list[tuple[int, int, int]], l_pac: int,
                max_chain_gap: int = 10000, band: int = 100
                ) -> list[Chain]:
    """Group seed occurrences (qbeg, qend, rbeg in 2L space) into chains,
    one seed at a time in (rbeg, qbeg) order.

    A seed joins the first chain on its strand that it is colinear with:
    it starts at or after the chain's start in query and text, the gaps
    to the chain's end differ by at most ``band``, both are under
    ``max_chain_gap``, and it does not reach back past its own length.
    Otherwise it starts a chain."""
    chains: list[Chain] = []
    for qb, qe, rb in sorted(occs, key=lambda s: (s[2], s[0])):
        slen = qe - qb
        for ch in chains:
            if (rb >= l_pac) != (ch.rbeg >= l_pac):
                continue
            dq = qb - ch.qend
            dr = rb - ch.rend
            if (qb >= ch.qbeg and rb >= ch.rbeg
                    and dr - dq <= band and dq - dr <= band
                    and dr < max_chain_gap and dq < max_chain_gap
                    and dq > -slen):
                ch.seeds.append((qb, slen, rb))
                ch.qend = max(ch.qend, qe)
                ch.rend = max(ch.rend, rb + slen)
                break
        else:
            chains.append(Chain(qb, qe, rb, rb + slen, [(qb, slen, rb)]))
    return chains


def filter_chains(chains: list[Chain], drop_ratio: float = 0.5,
                  min_weight: int = 0, max_keep: int = 8) -> list[Chain]:
    """bwa ``mem_chain_flt``-style filter: by weight, heaviest first
    (ties in input order), those of weight >= drop_ratio x the best and
    >= min_weight, at most max_keep."""
    if not chains:
        return []
    chains = sorted(chains, key=lambda c: -c.weight)
    best = chains[0].weight
    kept = [c for c in chains
            if c.weight >= drop_ratio * best and c.weight >= min_weight]
    return kept[:max_keep]


def chain_batch(rid: np.ndarray, qb: np.ndarray, qe: np.ndarray,
                p: np.ndarray, l_pac: int, band: int = 100,
                max_chain_gap: int = 10000, drop_ratio: float = 0.5,
                max_chains: int = 4):
    """Chain a whole batch of seed occurrences.

    rid/qb/qe/p: flat arrays over all valid occurrences (read id, query
    begin/end, text position).  Occurrences are grouped by (read,
    strand, diagonal within ``band``, text gap under ``max_chain_gap``);
    a chain's weight is its bounded query coverage, its anchor its
    longest seed (ties: smallest qb), and each read keeps its top
    ``max_chains`` chains of weight >= drop_ratio * its best.

    Returns a dict of per-chain int32 arrays: read, anchor_q,
    anchor_len, anchor_r, weight."""
    if rid.size == 0:
        return {k: np.empty(0, np.int32) for k in
                ("read", "anchor_q", "anchor_len", "anchor_r", "weight")}
    strand = (p >= l_pac).astype(np.int8)
    diag = p - qb
    order = np.lexsort((p, diag, strand, rid))
    r_s, st_s = rid[order], strand[order]
    d_s, p_s = diag[order], p[order]
    qb_s, qe_s = qb[order], qe[order]
    lens = (qe_s - qb_s).astype(np.int64)
    brk = np.ones(r_s.size, dtype=bool)
    if r_s.size > 1:
        brk[1:] = ((r_s[1:] != r_s[:-1]) | (st_s[1:] != st_s[:-1])
                   | (d_s[1:] - d_s[:-1] > band)
                   | (p_s[1:] - p_s[:-1] > max_chain_gap))
    starts = np.flatnonzero(brk)
    seg_id = np.cumsum(brk) - 1
    seg_read = r_s[starts]
    seg_qb = np.minimum.reduceat(qb_s, starts)
    seg_qe = np.maximum.reduceat(qe_s, starts)
    seg_rb = np.minimum.reduceat(p_s, starts)
    seg_re = np.maximum.reduceat(p_s + lens, starts)
    len_sum = np.add.reduceat(lens, starts)
    weight = np.minimum(len_sum,
                        np.minimum(seg_qe - seg_qb, seg_re - seg_rb))
    # anchor = longest seed per segment (ties: smallest qb)
    o2 = np.lexsort((qb_s, -lens, seg_id))
    _, first = np.unique(seg_id[o2], return_index=True)
    a_rows = o2[first]
    anchor_q = qb_s[a_rows]
    anchor_len = lens[a_rows]
    anchor_r = p_s[a_rows]
    # per-read filtering (segments are grouped by read already)
    n_seg = seg_read.size
    o3 = np.lexsort((-weight, seg_read))
    sr = seg_read[o3]
    new_read = np.ones(n_seg, dtype=bool)
    new_read[1:] = sr[1:] != sr[:-1]
    read_first = np.maximum.accumulate(
        np.where(new_read, np.arange(n_seg), 0))
    rank = np.arange(n_seg) - read_first
    best_w = weight[o3][read_first]
    keep_sorted = (rank < max_chains) & \
        (weight[o3] >= drop_ratio * best_w)
    keep = np.zeros(n_seg, dtype=bool)
    keep[o3] = keep_sorted
    return dict(read=seg_read[keep].astype(np.int32),
                anchor_q=anchor_q[keep].astype(np.int32),
                anchor_len=anchor_len[keep].astype(np.int32),
                anchor_r=anchor_r[keep].astype(np.int32),
                weight=weight[keep].astype(np.int32))
