"""String-graph construction, cleaning and unitig condensation (host
numpy; counterpart of seqlib_tpu/assembly/sgraph.py).

Nodes are ORIENTED reads (ids 2u = forward, 2u+1 = reverse complement
of unique read u); edges (a -> b, olen) mean b's prefix of length olen
equals a's suffix.  The join (overlap.find_overlaps) emits both
orientations, so the graph carries the twin symmetry a->b <=>
rc(b)->rc(a) by construction.

Cleaning honours fermi-lite's mag options:

* ``min_dratio1`` — per-node overlap drop ratio (SetDropOverlapRatio)
* ``aggressive`` — harsher tip/bubble thresholds (SetAggressiveTrim)
* ``simplify_bubble`` — bubble popping on/off (SetSimplifyBubble)
* ``min_elen`` / ``min_ensr`` / ``min_insr`` — tip length and
  read-support thresholds (DirectAssemble's kcov heuristic scales
  min_ensr)

Pipeline: reciprocal drop-ratio prune -> transitive reduction (Myers)
-> condense -> [pop bubbles -> trim tips -> re-condense] x rounds.  The
set operations are vectorised numpy over edge arrays; per-chain walks
are O(#unitigs).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class UtgNode:
    """One oriented unitig: merged sequence, per-base read coverage,
    supporting-read count, and the oriented-read chain it came from."""
    seq: np.ndarray                  # nt4 codes
    cov: np.ndarray                  # int32 per-base
    nsr: int
    chain: list[int]
    alive: bool = True
    twin: int = -1


def prune_edges(src: np.ndarray, dst: np.ndarray, olen: np.ndarray,
                n_nodes: int, min_dratio1: float, max_deg: int = 4):
    """Reciprocal drop-ratio pruning (mag's min_dratio1 + amend step).

    Keeps, per node side, overlaps with olen >= min_dratio1 * best and
    at most max_deg of them; an edge must survive from BOTH endpoints'
    point of view (a → b must be kept by a's out-side and b's in-side),
    mirroring mag_amend's reciprocity repair."""
    if src.size == 0:
        return src, dst, olen
    E = src.size
    # out-side best per src
    best_out = np.zeros(n_nodes, np.int64)
    np.maximum.at(best_out, src, olen)
    best_in = np.zeros(n_nodes, np.int64)
    np.maximum.at(best_in, dst, olen)
    keep = (olen >= min_dratio1 * best_out[src]) \
        & (olen >= min_dratio1 * best_in[dst])
    src, dst, olen = src[keep], dst[keep], olen[keep]

    def cap(src, dst, olen, by_out):
        if src.size == 0:
            return src, dst, olen
        key = src if by_out else dst
        order = np.lexsort((-olen, key))
        ks = key[order]
        seg = np.r_[True, ks[1:] != ks[:-1]]
        starts = np.flatnonzero(seg)
        sid = np.cumsum(seg) - 1
        rank = np.empty(order.size, np.int64)
        rank[order] = np.arange(order.size) - starts[sid]
        k2 = rank < max_deg
        return src[k2], dst[k2], olen[k2]

    # cap degree: keep the max_deg longest per out-side, then in-side
    src, dst, olen = cap(src, dst, olen, True)
    src, dst, olen = cap(src, dst, olen, False)
    return src, dst, olen


def transitive_reduction(src: np.ndarray, dst: np.ndarray,
                         olen: np.ndarray, lens: np.ndarray):
    """Myers-style transitive reduction on exact overlaps.

    Edge (i, k) is redundant iff some j gives (i, j) and (j, k) with
    ext(i,k) == ext(i,j) + ext(j,k), where ext = len(dst) - olen (the
    number of new bases dst contributes).  Vectorized via a sorted
    join on the middle node."""
    E = src.size
    if E == 0:
        return np.ones(0, bool)
    ext = lens[dst].astype(np.int64) - olen
    order2 = np.argsort(src, kind="stable")
    s2, d2, x2 = src[order2], dst[order2], ext[order2]
    lo = np.searchsorted(s2, dst, side="left")
    hi = np.searchsorted(s2, dst, side="right")
    span = hi - lo
    tot = int(span.sum())
    if tot == 0:
        return np.ones(E, bool)
    rep = np.repeat(np.arange(E), span)                 # e1 index
    offs = np.arange(tot) - np.repeat(np.cumsum(span) - span, span)
    e2 = lo[rep] + offs
    # candidate transitive edge: src[rep] -> d2[e2], ext sum
    ck = src[rep].astype(np.int64) * (lens.size + 1) + d2[e2]
    cx = ext[rep] + x2[e2]
    # existing edges keyed the same way
    ek = src.astype(np.int64) * (lens.size + 1) + dst
    eorder = np.argsort(ek, kind="stable")
    eks = ek[eorder]
    pos_lo = np.searchsorted(eks, ck, side="left")
    pos_hi = np.searchsorted(eks, ck, side="right")
    keep = np.ones(E, bool)
    # each (ck, cx) may match multiple parallel edges (rare); walk the
    # short collision ranges
    mult = pos_hi - pos_lo
    simple = mult == 1
    idx = eorder[np.minimum(pos_lo, E - 1)]
    hit = simple & (eks[np.minimum(pos_lo, E - 1)] == ck) \
        & (ext[idx] == cx) & (idx != rep)
    keep[idx[hit]] = False
    hard = np.flatnonzero(mult > 1)
    for t in hard:
        for q in range(int(pos_lo[t]), int(pos_hi[t])):
            e = eorder[q]
            if ext[e] == cx[t] and e != rep[t]:
                keep[e] = False
    return keep


def condense(n_nodes: int, seqs, covs, nsrs,
             src: np.ndarray, dst: np.ndarray, olen: np.ndarray,
             alive: np.ndarray, twin: np.ndarray):
    """Merge maximal simple chains into unitigs.

    seqs/covs: per oriented node nt4 array and per-base coverage;
    nsrs: supporting read count; twin[v] = v's reverse-complement node
    (-1 when unknown).  Returns (utgs, usrc, udst, uolen) where utgs is
    a list of UtgNode with twin pointers resolved."""
    out_cnt = np.zeros(n_nodes, np.int64)
    in_cnt = np.zeros(n_nodes, np.int64)
    live_e = alive[src] & alive[dst]
    src, dst, olen = src[live_e], dst[live_e], olen[live_e]
    np.add.at(out_cnt, src, 1)
    np.add.at(in_cnt, dst, 1)
    # unique successor map (only valid where out_cnt == 1)
    succ = np.full(n_nodes, -1, np.int64)
    succ_o = np.zeros(n_nodes, np.int64)
    one_out = out_cnt[src] == 1
    succ[src[one_out]] = dst[one_out]
    succ_o[src[one_out]] = olen[one_out]
    pred = np.full(n_nodes, -1, np.int64)
    one_in = in_cnt[dst] == 1
    pred[dst[one_in]] = src[one_in]

    def extendable(a, b):
        """chain edge a->b usable: unique out of a, unique in of b."""
        return b >= 0 and out_cnt[a] == 1 and in_cnt[b] == 1 \
            and pred[b] == a

    visited = np.zeros(n_nodes, bool)
    node_of = np.full(n_nodes, -1, np.int64)   # oriented node -> utg id
    utgs: list[UtgNode] = []
    order_ids = np.flatnonzero(alive)
    # chain starts: cannot extend left
    for v in order_ids:
        if visited[v]:
            continue
        p = pred[v]
        if p >= 0 and alive[p] and out_cnt[p] == 1 and in_cnt[v] == 1:
            continue                       # not a head
        chain = [int(v)]
        visited[v] = True
        cur = int(v)
        while True:
            nxt = int(succ[cur])
            if nxt < 0 or not alive[nxt] or visited[nxt] \
                    or not extendable(cur, nxt):
                break
            chain.append(nxt)
            visited[nxt] = True
            cur = nxt
        utgs.append(_merge_chain(chain, seqs, covs, nsrs, succ_o))
        for c in chain:
            node_of[c] = len(utgs) - 1
    # cycles remain unvisited heads: walk them too
    for v in order_ids:
        if visited[v]:
            continue
        chain = [int(v)]
        visited[v] = True
        cur = int(v)
        while True:
            nxt = int(succ[cur])
            if nxt < 0 or visited[nxt] or not extendable(cur, nxt):
                break
            chain.append(nxt)
            visited[nxt] = True
            cur = nxt
        utgs.append(_merge_chain(chain, seqs, covs, nsrs, succ_o))
        for c in chain:
            node_of[c] = len(utgs) - 1

    # unitig-level edges: edges whose src is a chain tail and dst a head
    heads = {u.chain[0]: i for i, u in enumerate(utgs)}
    tails = {u.chain[-1]: i for i, u in enumerate(utgs)}
    ue = {}
    for s, d, o in zip(src.tolist(), dst.tolist(), olen.tolist()):
        us = tails.get(s)
        ud = heads.get(d)
        if us is None or ud is None or us == ud:
            continue
        key = (us, ud)
        if key not in ue or ue[key] < o:
            ue[key] = o
    usrc = np.array([k[0] for k in ue], np.int64)
    udst = np.array([k[1] for k in ue], np.int64)
    uolen = np.array(list(ue.values()), np.int64)

    # resolve twins: the twin of chain [a, b, ..., z] is [rc z, ..., rc a]
    head_tw = {}
    for i, u in enumerate(utgs):
        head_tw[(int(twin[u.chain[-1]]), int(twin[u.chain[0]]))] = i
    for i, u in enumerate(utgs):
        u.twin = head_tw.get((u.chain[0], u.chain[-1]), -1)
    return utgs, usrc, udst, uolen


def _merge_chain(chain, seqs, covs, nsrs, succ_o):
    seq = seqs[chain[0]]
    cov = covs[chain[0]].astype(np.int32).copy()
    nsr = int(nsrs[chain[0]])
    for a, b in zip(chain, chain[1:]):
        o = int(succ_o[a])
        sb = seqs[b]
        cb = covs[b]
        new = np.concatenate([seq, sb[o:]])
        nc = np.concatenate([cov, np.zeros(len(sb) - o, np.int32)])
        nc[len(seq) - o:] += cb
        seq, cov = new, nc
        nsr += int(nsrs[b])
    return UtgNode(seq=seq, cov=cov, nsr=nsr, chain=list(chain))


def clean_unitigs(utgs: list[UtgNode], usrc, udst, uolen,
                  min_elen: int, min_ensr: int, min_insr: int,
                  simplify_bubble: bool, aggressive: bool):
    """One round of mag-style cleaning on the unitig graph.

    Tips (mag_g_trim): a unitig with a free end, shorter than min_elen
    and supported by fewer than min_ensr reads (min_insr when both ends
    are connected... internal) is dropped.  Bubbles (mag_popbub): two
    unitigs sharing the same single predecessor and successor — keep
    the better-supported side.  Decisions are applied to a unitig and
    its twin together so the graph stays rc-symmetric.  Returns True
    if anything was removed."""
    n = len(utgs)
    out_cnt = np.zeros(n, np.int64)
    in_cnt = np.zeros(n, np.int64)
    if usrc.size:
        np.add.at(out_cnt, usrc, 1)
        np.add.at(in_cnt, udst, 1)
    changed = False

    def kill(i):
        nonlocal changed
        if i < 0 or not utgs[i].alive:
            return
        utgs[i].alive = False
        changed = True
        t = utgs[i].twin
        if t >= 0:
            utgs[t].alive = False

    ensr = min_ensr + 2 if aggressive else min_ensr
    elen = min_elen
    for i, u in enumerate(utgs):
        if not u.alive:
            continue
        n_free = int(out_cnt[i] == 0) + int(in_cnt[i] == 0)
        if n_free == 1 and len(u.seq) < elen and u.nsr < ensr:
            kill(i)           # true tip: dead-end branch of the graph
        elif n_free == 2 and len(u.seq) < elen and u.nsr < 2:
            kill(i)           # isolated junk singleton (error read)

    if simplify_bubble and usrc.size:
        # group edges: pred -> list of (mid, succ) where mid has
        # exactly one in and one out edge
        one_io = (out_cnt == 1) & (in_cnt == 1)
        succ_of = {}
        pred_of = {}
        for s, d in zip(usrc.tolist(), udst.tolist()):
            if one_io[d]:
                pred_of.setdefault(d, []).append(s)
            if one_io[s]:
                succ_of.setdefault(s, []).append(d)
        buckets: dict[tuple[int, int], list[int]] = {}
        for m in range(n):
            if not utgs[m].alive or not one_io[m]:
                continue
            p = pred_of.get(m)
            s = succ_of.get(m)
            if not p or not s:
                continue
            buckets.setdefault((p[0], s[0]), []).append(m)
        for (p, s), mids in buckets.items():
            live = [m for m in mids if utgs[m].alive]
            if len(live) < 2:
                continue
            # keep the best-supported branch (ties: longer, then id)
            live.sort(key=lambda m: (-utgs[m].nsr, -len(utgs[m].seq), m))
            keep_nsr = utgs[live[0]].nsr
            for m in live[1:]:
                if aggressive or utgs[m].nsr < max(min_insr, 1) \
                        or utgs[m].nsr * 2 <= keep_nsr:
                    kill(m)
    return changed


def reexpand(utgs: list[UtgNode], usrc, udst, uolen):
    """Flatten live unitigs back to node arrays for another condense
    round (after cleaning removed nodes, chains may extend)."""
    alive_ids = [i for i, u in enumerate(utgs) if u.alive]
    remap = {i: k for k, i in enumerate(alive_ids)}
    seqs = [utgs[i].seq for i in alive_ids]
    covs = [utgs[i].cov for i in alive_ids]
    nsrs = [utgs[i].nsr for i in alive_ids]
    keep = [(s in remap) and (d in remap)
            for s, d in zip(usrc.tolist(), udst.tolist())]
    keep = np.array(keep, bool) if len(keep) else np.zeros(0, bool)
    src = np.array([remap[s] for s in usrc[keep].tolist()], np.int64)
    dst = np.array([remap[d] for d in udst[keep].tolist()], np.int64)
    ol = uolen[keep]
    twins = [remap.get(utgs[i].twin, -1) for i in alive_ids]
    return seqs, covs, nsrs, src, dst, ol, twins
