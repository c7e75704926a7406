"""Vectorised suffix-prefix overlap detection by sort-join (host numpy;
counterpart of seqlib_tpu/assembly/overlap.py).

1. pack every read's first SEED bases into one uint64 prefix key;
2. pack every suffix window's first SEED bases the same way (one
   vectorised shift/or sweep over the [N, L] code matrix);
3. ``searchsorted`` the suffix keys into the sorted prefix keys: every
   hit is a candidate (i, j, olen) proper overlap;
4. verify the rest of each candidate overlap with packed-key compares
   (no per-pair Python).
"""

from __future__ import annotations

import numpy as np


def pack_prefix_keys(codes: np.ndarray, seed: int) -> np.ndarray:
    """codes [N, L] nt4 (4=pad) -> uint64 keys of the first `seed`
    bases (reads shorter than seed get all-ones sentinel)."""
    N, L = codes.shape
    out = np.zeros(N, np.uint64)
    bad = np.zeros(N, bool)
    for j in range(seed):
        c = codes[:, j] if j < L else np.full(N, 4, np.uint8)
        bad |= c > 3
        out = (out << np.uint64(2)) | (c & 3).astype(np.uint64)
    return np.where(bad, np.uint64(0xFFFFFFFFFFFFFFFF), out)


def pack_window_keys(codes: np.ndarray, seed: int) -> np.ndarray:
    """All seed-length windows: [N, L-seed+1] uint64 (sentinel where
    the window crosses a pad/N base)."""
    N, L = codes.shape
    n = L - seed + 1
    if n <= 0:
        return np.empty((N, 0), np.uint64)
    out = np.zeros((N, n), np.uint64)
    bad = np.zeros((N, n), bool)
    for j in range(seed):
        c = codes[:, j:j + n]
        bad |= c > 3
        out = (out << np.uint64(2)) | (c & 3).astype(np.uint64)
    return np.where(bad, np.uint64(0xFFFFFFFFFFFFFFFF), out)


def find_overlaps(codes: np.ndarray, lens: np.ndarray, min_ovlp: int,
                  max_cand_per_suffix: int = 8,
                  chunk: int = 1 << 18):
    """Proper suffix-prefix overlaps among oriented reads.

    codes [N, L] nt4 (4-padded); lens [N].  Returns
    (src, dst, olen, contained): int32 arrays where read ``dst``'s
    prefix of length olen equals read ``src``'s suffix, with
    min_ovlp <= olen < min(len(src), len(dst)); ``contained`` is a
    bool [N] mask of reads that occur in full inside another read
    (at a suffix-window position) -- the assembler drops those, as
    fermi-lite's mag construction does.
    """
    N, L = codes.shape
    seed = min(int(min_ovlp), 32)
    pref = pack_prefix_keys(codes, seed)
    order = np.argsort(pref, kind="stable")
    sorted_pref = pref[order]

    win = pack_window_keys(codes, seed)              # [N, n]
    n = win.shape[1]
    # suffix start positions p >= 1 with len-p >= min_ovlp
    # olen = len_i - p
    pos_i, pos_p = np.nonzero(
        (np.arange(n)[None, :] >= 1)
        & (np.arange(n)[None, :] <= (lens - min_ovlp)[:, None]))
    keys = win[pos_i, pos_p]
    ok = keys != np.uint64(0xFFFFFFFFFFFFFFFF)
    pos_i, pos_p, keys = pos_i[ok], pos_p[ok], keys[ok]

    lo = np.searchsorted(sorted_pref, keys, side="left")
    hi = np.searchsorted(sorted_pref, keys, side="right")
    span = np.minimum(hi - lo, max_cand_per_suffix)
    tot = int(span.sum())
    contained = np.zeros(N, bool)
    if tot == 0:
        empty = np.empty(0, np.int32)
        return empty, empty, empty, contained
    # expand candidate ranges
    rep = np.repeat(np.arange(pos_i.size), span)
    offs = np.arange(tot) - np.repeat(np.cumsum(span) - span, span)
    cand_j = order[lo[rep] + offs]
    cand_i = pos_i[rep]
    cand_p = pos_p[rep]
    keep = cand_j != cand_i
    cand_i, cand_j, cand_p = cand_i[keep], cand_j[keep], cand_p[keep]
    olen = (lens[cand_i] - cand_p).astype(np.int64)
    # containment candidates: the suffix window is at least as long as
    # dst, i.e. dst may sit entirely inside src at position p
    is_cont = olen >= lens[cand_j]
    # pre-verification cap: the graph keeps only ~4 longest overlaps
    # per node side, so verifying more than 2x that per source is
    # wasted work (containment candidates are always verified)
    cap = 2 * max_cand_per_suffix
    order = np.lexsort((-olen, cand_i))
    ks = cand_i[order]
    seg = np.r_[True, ks[1:] != ks[:-1]] if ks.size else np.zeros(0, bool)
    starts = np.flatnonzero(seg)
    sid = np.cumsum(seg) - 1
    rank = np.empty(order.size, np.int64)
    rank[order] = np.arange(order.size) - starts[sid]
    keepc = is_cont | (rank < cap)
    cand_i, cand_j, cand_p = cand_i[keepc], cand_j[keepc], cand_p[keepc]
    olen, is_cont = olen[keepc], is_cont[keepc]
    # verified length: full dst for containment, olen for proper
    vlen = np.where(is_cont, lens[cand_j], olen)

    # verify the remainder beyond the seed using the PACKED window
    # keys: seed-base blocks at offsets seed, 2*seed, ... plus one
    # (possibly overlapping) tail block ending exactly at vlen — a
    # handful of uint64 compares per candidate instead of a byte
    # matrix
    M = cand_i.size
    good = np.ones(M, bool)
    if M:
        max_v = int(vlen.max())
        off = seed
        while off + seed <= max_v:
            need = (off + seed) <= vlen
            a = win[cand_i, np.minimum(cand_p + off, n - 1)]
            b = win[cand_j, off]
            good &= ~need | (a == b)
            off += seed
        tail = vlen - seed
        need = tail > 0
        ts = np.maximum(tail, 0)
        a = win[cand_i, np.minimum(cand_p + ts, n - 1)]
        b = win[cand_j, np.minimum(ts, n - 1)]
        good &= ~need | (a == b)
    contained[cand_j[good & is_cont]] = True
    prop = good & ~is_cont
    return (cand_i[prop].astype(np.int32), cand_j[prop].astype(np.int32),
            olen[prop].astype(np.int32), contained)
