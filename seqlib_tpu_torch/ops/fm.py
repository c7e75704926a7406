"""Device FM-index ops: rank, FMD bi-extension, SA locate and the SMEM
seed machine (counterpart of seqlib_tpu/ops/fm.py, and of
seqlib_tpu/ops/fm_hilo.py and fm_wide.py for wide indexes).

``DeviceFMIndex.blocks`` holds, per 128-base block, the 4 occurrence
checkpoints followed by the 8 packed BWT words (16 bases per word,
first base in the top 2 bits).  On a narrow index (2L text under 2^31)
a row is 12 unsigned 32-bit values in an int32 tensor (48 bytes); on a
wide one it is 8 int64 values (64 bytes): the 4 checkpoints as int64,
then the 8 words, two to an int64 (word 2j in the low half), so its
bytes are 4 int64 counts and then the 8 uint32 words.  The CUDA kernel
reads either layout; the plain PyTorch functions widen a gathered row
to 12 int64 values (PyTorch has no popcount and thin uint32 support)
and count with a SWAR popcount.  Every rank, interval and position is
int64 in the plain functions, so one code path serves both: the JAX
package's hi/lo int32 pairs exist only because of the TPU.

``DeviceFMIndex.sa`` is the full suffix array of a constructed index
(``sa_intv`` 1: a locate is one gather) or the rank-sampled one of an
index loaded from bwa's files (``sa_intv`` 32: a locate walks LF to a
sample, as the JAX package does in XLA: one launch of the walk kernel
``csrc/sa_walk.cu`` on CUDA tensors, the plain loop ``_sa_walk`` on CPU
tensors).

``_smem_machine`` is the plain version of kernel K2
(``csrc/smem_machine.cu``); ``smem_collect`` and ``smem_reseed`` reach
it through ``smem_machine``, which launches the kernel
(``ops.fm_cuda``) on CUDA tensors.  Interval starts leave the machine
as int32 on a narrow index and int64 on a wide one; interval sizes
leave it clamped to int32 on both, as the JAX package's ``_sz32`` does
(they are only compared with small caps).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import profiling
from ..device import resolve_device
from . import fm_cuda

M32 = 0xFFFFFFFF
M55 = 0x55555555
I32_MAX = (1 << 31) - 1


@dataclass
class DeviceFMIndex:
    """FM-index arrays resident on one device."""

    blocks: torch.Tensor     # int32 [nb+1, 12] narrow; int64 [nb+1, 8] wide
    sa: torch.Tensor         # int64 SA of ranks 0, sa_intv, ... (sa[0] = 0)
    L2: torch.Tensor         # int64 [5]
    L2_host: tuple           # the same five counts as Python ints
    primary: int
    seq_len: int
    l_pac: int
    sa_intv: int = 1         # 1: the full SA; else sampled by rank
    # copies on other devices (``to``), made once each
    _copies: dict = field(default_factory=dict, repr=False, compare=False)
    _copies_lock: threading.Lock = field(default_factory=threading.Lock,
                                         repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def to(self, device) -> "DeviceFMIndex":
        """This index on ``device``: itself where it lies there already,
        else a copy of every tensor, made once per device and kept (a
        mesh replicates its index so)."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        with self._copies_lock:
            out = self._copies.get(dev)
            if out is None:
                out = DeviceFMIndex(
                    blocks=self.blocks.to(dev), sa=self.sa.to(dev),
                    L2=self.L2.to(dev), L2_host=self.L2_host,
                    primary=self.primary, seq_len=self.seq_len,
                    l_pac=self.l_pac, sa_intv=self.sa_intv)
                self._copies[dev] = out
        return out

    @property
    def wide(self) -> bool:
        """int64 checkpoint rows (ranks past 2^31 representable)."""
        return self.blocks.dtype == torch.int64

    @classmethod
    def from_host(cls, idx, device="cuda", wide: bool | None = None,
                  count_bias=None) -> "DeviceFMIndex":
        """Upload a host :class:`~seqlib_tpu_torch.index.FMIndex`: its
        full SA with ``sa_intv`` 1 when it has one (a constructed
        index), else its samples with the file's interval (a loaded
        one).

        ``wide`` picks the 64-byte int64 rows; by default an index whose
        2L text is 2^31 or more gets them, and a narrow upload of such
        an index raises (its ranks do not fit int32).  ``count_bias``
        (int64 [4], wide only) adds bias[c] to every checkpoint of code
        c, so rank'(c, k) = rank(c, k) + bias[c]: the JAX package's test
        hook that gives ranks past 2^31 on a small index.

        While the tracer is on, the span ``index.upload`` covers the
        tables' layout and copy, and the counters ``index.occ_bytes`` and
        ``index.sa_bytes`` take the bytes of the checkpoint rows and of
        the SA put on the device."""
        dev = resolve_device(device)
        if wide is None:
            wide = idx.seq_len >= 2**31
        if not wide and idx.seq_len >= 2**31:
            raise ValueError(
                f"a 2L text of {idx.seq_len} >= 2^31 needs wide=True")
        if count_bias is not None and not wide:
            raise ValueError("count_bias needs wide=True")
        with profiling.span("index.upload"):
            nb = idx.bwt_words.shape[0]
            cp = idx.cp_counts.astype(np.int64)[:nb + 1]
            words = np.zeros((nb + 1, 8), np.uint32)
            words[:nb] = idx.bwt_words
            if wide:
                if count_bias is not None:
                    cp = cp + np.asarray(count_bias, np.int64)[None, :]
                blocks = np.concatenate(
                    [cp, np.ascontiguousarray(words).view(np.int64)], axis=1)
            else:
                blocks = np.concatenate(
                    [cp.astype(np.uint32), words], axis=1).view(np.int32)
            if idx.sa_full is not None:
                sa, sa_intv = idx.sa_full.astype(np.int64), 1
            else:
                sa = idx.sa_samples.astype(np.int64)
                sa_intv = int(idx.sa_intv)
            sa[0] = 0
            L2 = np.asarray(idx.L2, np.int64)
            out = cls(
                blocks=torch.from_numpy(np.ascontiguousarray(blocks)).to(dev),
                sa=torch.from_numpy(sa).to(dev),
                L2=torch.from_numpy(L2.copy()).to(dev),
                L2_host=tuple(int(v) for v in L2),
                primary=int(idx.primary), seq_len=int(idx.seq_len),
                l_pac=int(idx.l_pac), sa_intv=sa_intv)
            profiling.placed("index.occ_bytes", out.blocks)
            profiling.placed("index.sa_bytes", out.sa)
        return out


# ---------------------------------------------------------------------------
# rank
# ---------------------------------------------------------------------------

def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in the low 32 bits of int64 ``x`` (SWAR)."""
    x = x & M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def _inblock_count(words: torch.Tensor, c, within: torch.Tensor
                   ) -> torch.Tensor:
    """Occurrences of 2-bit code c among the first ``within`` bases of a
    block given its 8 packed words (int64 [..., 8]); c int or tensor."""
    # a Python int stays a scalar: a device tensor made from it is a
    # host-to-device copy that waits for the stream at every call
    pat = (c.to(torch.int64) * M55)[..., None] if torch.is_tensor(c) \
        else int(c) * M55
    nx = ~(words ^ pat) & M32
    m = nx & (nx >> 1) & M55
    j16 = torch.arange(8, dtype=torch.int64, device=words.device) * 16
    t = torch.clamp(within[..., None] - j16, 0, 16)
    mask = torch.where(t > 0, (M32 << (32 - 2 * t)) & M32,
                       torch.zeros_like(t))
    return popcount32(m & mask).sum(dim=-1)


def _rows(fm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """Block rows holding rank position k, as int64 [..., 12]: the 4
    checkpoints, then the 8 BWT words."""
    row = fm.blocks[k >> 7]
    if not fm.wide:
        return row.to(torch.int64) & M32
    pairs = row[..., 4:]
    words = torch.stack([pairs & M32, (pairs >> 32) & M32], dim=-1)
    return torch.cat([row[..., :4], words.flatten(-2)], dim=-1)


def rank(fm: DeviceFMIndex, c, k: torch.Tensor) -> torch.Tensor:
    """# of c in bwt[0..k-1], k in [0, seq_len]."""
    c = torch.as_tensor(c, dtype=torch.int64, device=k.device)
    c, k = torch.broadcast_tensors(c, k.to(torch.int64))
    row = _rows(fm, k)
    base = row[..., :4].gather(-1, c[..., None])[..., 0]
    return base + _inblock_count(row[..., 4:], c, k & 127)


def rank_full(fm: DeviceFMIndex, c, k: torch.Tensor) -> torch.Tensor:
    """Rank over BWT_full (sentinel at row ``primary``)."""
    k = k.to(torch.int64)
    return rank(fm, c, k - (k > fm.primary).to(torch.int64))


def rank4(fm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """Counts of all four codes in bwt[0..k-1] -> [..., 4]."""
    k = k.to(torch.int64)
    row = _rows(fm, k)
    words, within = row[..., 4:], k & 127
    cnt = torch.stack([_inblock_count(words, c, within) for c in range(4)],
                      dim=-1)
    return row[..., :4] + cnt


def rank4_full(fm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    k = k.to(torch.int64)
    return rank4(fm, k - (k > fm.primary).to(torch.int64))


def bi_extend_back(fm: DeviceFMIndex, k, l, s):
    """FMD backward extension of bi-interval (k, l, s) by all 4 codes.

    Returns (k4, l4, s4), each [..., 4]; index a is the bi-interval of
    a+P.  Forward extension by b is ``bi_extend_back(fm, l, k, s)``
    selecting 3-b with (k4, l4) swapped."""
    k = k.to(torch.int64)
    l = l.to(torch.int64)
    s = s.to(torch.int64)
    tk = rank4_full(fm, k)
    tl = rank4_full(fm, k + s)
    s4 = tl - tk
    k4 = fm.L2[:4] + 1 + tk
    has_sent = ((k <= fm.primary) & (fm.primary < k + s)).to(torch.int64)
    l3 = l + has_sent
    l2 = l3 + s4[..., 3]
    l1 = l2 + s4[..., 2]
    l0 = l1 + s4[..., 1]
    return k4, torch.stack([l0, l1, l2, l3], dim=-1), s4


def rank_words(fm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """BWT words a rank at BWT_full position k popcounts: the block
    prefix before k holds ceil((k' & 127) / 16) words (k' sentinel-
    adjusted)."""
    k = k.to(torch.int64)
    k = k - (k > fm.primary).to(torch.int64)
    return ((k & 127) + 15) >> 4


def _take4(a4: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return a4.gather(-1, c[..., None])[..., 0]


def backward_ext(fm: DeviceFMIndex, l: torch.Tensor, u: torch.Tensor,
                 c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[l, u) -> the interval of c + pattern (int64), batched over the
    leading dims; both boundary ranks in one stacked gather."""
    c = c.to(torch.int64)
    lu = torch.stack([l.to(torch.int64), u.to(torch.int64)])
    r = rank_full(fm, c.expand_as(lu), lu)
    C = fm.L2[c] + 1
    return C + r[0], C + r[1]


# ---------------------------------------------------------------------------
# greedy seed scan: maximal exact matches ending at e, restart at s - 2
# ---------------------------------------------------------------------------

def collect_seeds(fm: DeviceFMIndex, reads: torch.Tensor, lens: torch.Tensor,
                  max_seeds: int = 16, min_seed_len: int = 19) -> dict:
    """Lockstep greedy seed scan over a read batch (the JAX package's
    ``collect_seeds``, its data-parallel seed step).

    For each read (nt4 codes, padded with 4) scan the end e from len - 1
    down; backward-extend to the maximal start s; emit [s, e] with its
    SA interval when it is at least ``min_seed_len`` long; restart at
    e' = s - 2, skipping the mismatching base.  The trip count is
    L + max_seeds + 2 steps, two a round and the test "a read is still
    scanning" before each round, as in the JAX package; a finished read
    stays as it is.

    Returns qbeg, qend (exclusive) int32 [B, max_seeds], intv_l and
    intv_sz int64 [B, max_seeds], n_seeds int32 [B]."""
    B, L = reads.shape
    dev = reads.device
    i64 = torch.int64
    n1 = fm.seq_len + 1
    e = lens.to(i64) - 1                 # current end position
    p = e.clone()                        # next char to consume
    l = torch.zeros(B, dtype=i64, device=dev)
    u = torch.full((B,), n1, dtype=i64, device=dev)
    n = torch.zeros(B, dtype=i64, device=dev)   # seeds emitted
    qbeg = torch.zeros((B, max_seeds), dtype=i64, device=dev)
    qend, intv_l, intv_sz = (torch.zeros_like(qbeg) for _ in range(3))
    s_iota = torch.arange(max_seeds, dtype=i64, device=dev)[None, :]
    rows = torch.arange(B, device=dev)
    codes = reads.to(i64)

    def step(e, p, l, u, n):
        active = e >= 0
        c = torch.where(active & (p >= 0),
                        codes[rows, torch.clamp(p, min=0)], 4)
        valid_c = c < 4
        nl, nu = backward_ext(fm, l, u, torch.clamp(c, max=3))
        nl = torch.where(valid_c, nl, 0)
        nu = torch.where(valid_c, nu, 0)
        dead = nu <= nl
        hit_start = p < 0
        # emit [p + 1, e] when the extension dies or runs off the start
        ok = active & (dead | hit_start) & (e - p >= min_seed_len) \
            & (u > l) & (n < max_seeds)
        hot = ok[:, None] & (s_iota == n[:, None])
        qbeg[hot] = (p + 1)[:, None].expand_as(hot)[hot]
        qend[hot] = (e + 1)[:, None].expand_as(hot)[hot]
        intv_l[hot] = l[:, None].expand_as(hot)[hot]
        intv_sz[hot] = (u - l)[:, None].expand_as(hot)[hot]
        n = n + ok.to(i64)
        adv = active & ~dead & ~hit_start
        restart = active & (dead | hit_start)
        new_e = torch.where(restart, p - 1, e)
        return (new_e, torch.where(adv, p - 1, new_e),
                torch.where(adv, nl, 0), torch.where(adv, nu, n1), n)

    it = 0
    while bool((e >= 0).any()) and it < L + max_seeds + 2:
        for _ in range(2):
            e, p, l, u, n = step(e, p, l, u, n)
        it += 2
    i32 = torch.int32
    return dict(qbeg=qbeg.to(i32), qend=qend.to(i32), intv_l=intv_l,
                intv_sz=intv_sz, n_seeds=n.to(i32))


# ---------------------------------------------------------------------------
# SA locate: one gather on the full SA, an LF walk on the samples
# ---------------------------------------------------------------------------

# LF steps between two tests of "every lane done" (each test is a host
# sync); a lane that is done stays frozen, so this changes no result
WALK_CHECK = 8


def bwt_char(fm: DeviceFMIndex, p: torch.Tensor) -> torch.Tensor:
    """Stored-BWT code at BWT position p (already sentinel-adjusted)."""
    p = p.to(torch.int64)
    j = (p >> 4) & 7
    if fm.wide:
        word = (fm.blocks[p >> 7, 4 + (j >> 1)] >> (32 * (j & 1))) & M32
    else:
        word = fm.blocks[p >> 7, 4 + j].to(torch.int64) & M32
    return (word >> (2 * (15 - (p & 15)))) & 3


def _lf(fm: DeviceFMIndex, r: torch.Tensor) -> torch.Tensor:
    """LF(r) = L2[c] + 1 + rank_full(c, r), c the BWT code of rank r:
    ``bwt_char`` and ``rank_full`` read the same block row, so one
    gather serves both."""
    p = r - (r > fm.primary).to(torch.int64)
    row = _rows(fm, p)
    word = row[:, 4:].gather(1, ((p >> 4) & 7)[:, None])[:, 0]
    c = (word >> (2 * (15 - (p & 15)))) & 3
    occ = row.gather(1, c[:, None])[:, 0] \
        + _inblock_count(row[:, 4:], c, p & 127)
    return fm.L2[c] + 1 + occ


def sa_lookup(fm: DeviceFMIndex, ranks: torch.Tensor,
              return_steps: bool = False):
    """Text positions for ranks (-1 where rank < 0).

    On a sampled SA (samples by rank: ``isa % sa_intv == 0``) each valid
    rank walks LF until it is a multiple of ``sa_intv`` or is
    ``primary`` (SA 0), and its position is the sample plus the steps
    taken.  As in the JAX package the walk stops after ``64 * sa_intv``
    steps; a lane still walking then gets ``sa[r // sa_intv] + steps``.
    The walk is one kernel launch on CUDA tensors
    (``fm_cuda.sa_walk_cuda``), the plain loop ``_sa_walk`` on CPU
    tensors.  With ``return_steps`` also returns each rank's steps (0 on
    the full SA)."""
    ranks = ranks.to(torch.int64)
    if fm.sa_intv == 1:
        r0 = torch.clamp(ranks, min=0)
        pos = torch.where(r0 == fm.primary, 0, fm.sa[r0])
        pos = torch.where(ranks < 0, -1, pos)
        return (pos, torch.zeros_like(pos)) if return_steps else pos
    walk = fm_cuda.sa_walk_cuda if ranks.is_cuda else _sa_walk
    pos, steps = walk(fm, ranks, return_steps)
    return (pos, steps) if return_steps else pos


def _sa_walk(fm: DeviceFMIndex, ranks: torch.Tensor,
             return_steps: bool = False):
    """The plain version of the walk kernel (``csrc/sa_walk.cu``):
    (positions, steps or None) for int64 ranks on a sampled SA.  Only
    the valid ranks walk, compacted, in rounds of ``WALK_CHECK`` steps;
    lanes that are done leave the walk at each round's test (two reads
    of the device, ``sync.locate.done`` and ``sync.locate.keep``).
    While the tracer is on it counts the kernel's totals
    (``locate.lanes``, ``locate.lane_steps``: exact LF steps,
    ``locate.capped``: lanes that walked the cap's steps) and its own
    ``locate.rounds``; ``sa_lookup`` runs it on CPU tensors only, where
    reading those totals costs no wait."""
    intv, cap = fm.sa_intv, 64 * fm.sa_intv
    flat = ranks.reshape(-1)
    pos = torch.full_like(flat, -1)
    steps_out = torch.zeros_like(flat)
    with profiling.sync("locate.lanes"):
        lane = torch.nonzero(flat >= 0)[:, 0]
    profiling.count("locate.lanes", lane.numel())
    r = flat[lane]
    steps = torch.zeros_like(r)
    done = (r % intv == 0) | (r == fm.primary)
    it = 0
    while True:
        if it >= cap:
            done = torch.ones_like(done)
        with profiling.sync("locate.done"):
            sel = torch.nonzero(done)[:, 0]
        rs, ss = r[sel], steps[sel]
        pos[lane[sel]] = torch.where(rs == fm.primary, 0,
                                     fm.sa[rs // intv]) + ss
        steps_out[lane[sel]] = ss
        with profiling.sync("locate.keep"):
            keep = torch.nonzero(~done)[:, 0]
        if keep.numel() == 0:
            break
        lane, r, steps = lane[keep], r[keep], steps[keep]
        done = torch.zeros_like(keep, dtype=torch.bool)
        n = min(WALK_CHECK, cap - it)
        profiling.count("locate.rounds")
        for _ in range(n):
            r = torch.where(done, r, _lf(fm, r))
            steps = steps + (~done).to(torch.int64)
            done = done | (r % intv == 0) | (r == fm.primary)
        it += n
    if profiling.enabled():
        # values the CPU holds (``tolist`` dispatches no scalar read)
        total, capped = torch.stack(
            [steps_out.sum(), (steps_out == cap).sum()]).tolist()
        profiling.count("locate.lane_steps", total)
        profiling.count("locate.capped", capped)
    pos = pos.reshape(ranks.shape)
    return pos, steps_out.reshape(ranks.shape) if return_steps else None


# ---------------------------------------------------------------------------
# SMEM machine: plain version of kernel K2
# ---------------------------------------------------------------------------

M_INIT, M_FWD, M_BWD, M_DONE = 0, 1, 2, 3


def _smem_machine(fm: DeviceFMIndex, reads, lens, x0, min_intv, active,
                  max_seeds: int, min_seed_len: int, C: int,
                  max_rounds: int, step_cap: int,
                  p3_seeds: int = 0, p3_max_intv: int = 20,
                  count_work: bool = False):
    """Per-lane SMEM state machine (bwa ``mem_collect_intv`` rounds of
    ``bwt_smem1``, flattened to INIT/FWD/BWD/DONE), optionally with
    bwa's third seeding pass (``bwt_seed_strategy1``) as a second,
    independent scan in the same lanes.

    reads uint8/int [B, L] nt4 codes; lens, x0, min_intv [B]; active
    bool [B].  A lane runs at most ``step_cap`` steps; a lane still
    busy then counts in n_dropped.  Returns dict(qbeg, qend,
    intv_l, intv_sz [B, max_seeds], n_seeds, n_dropped [B]), int32 but
    intv_l int64 on a wide index and intv_sz clamped to int32, plus, with
    ``p3_seeds``, p3_qbeg/p3_qend/p3_intv_l/p3_intv_sz [B, p3_seeds]
    and p3_n [B].  ``count_work`` adds int64 [B] counts of the work
    kernel K2 does per lane: "steps" (loop iterations while busy),
    "rounds" (steps that run at least one FMD bi-extension: each waits
    on the previous step's block loads), "exts" (bi-extensions) and
    "rank_words" (BWT words popcounted, two ranks per extension)."""
    dev = reads.device
    B, L = reads.shape
    i64 = torch.int64
    reads = reads.to(i64)
    lens = lens.to(i64)
    min_intv = min_intv.to(i64)
    L2 = fm.L2
    cidx = torch.arange(C, dtype=i64, device=dev)[None, :]
    sidx = torch.arange(max_seeds, dtype=i64, device=dev)[None, :]
    z = torch.zeros(B, dtype=i64, device=dev)
    zc = torch.zeros((B, C), dtype=i64, device=dev)
    zs = torch.zeros((B, max_seeds), dtype=i64, device=dev)

    def rd(pos):
        return reads.gather(1, pos.clamp(0, L - 1)[:, None])[:, 0]

    work = dict(steps=z, rounds=z, exts=z, rank_words=z)

    def count(ext, k, s):
        """Add the bi-extensions of ``ext`` lanes at (k, s) to ``work``."""
        words = rank_words(fm, k) + rank_words(fm, k + s)
        work["exts"] = work["exts"] + ext.to(i64)
        work["rank_words"] = work["rank_words"] + torch.where(ext, words, 0)

    st = dict(
        mode=torch.where(active.bool() & (x0.to(i64) < lens),
                         torch.full_like(z, M_INIT),
                         torch.full_like(z, M_DONE)),
        x=x0.to(i64).clone(), nx=z, i=z, k=z, l=z, s=z, end=z,
        sk=zc, sl=zc, ss=zc, se=zc, sn=z, bj=z, bk=z, bl=z, bs=z, be=z,
        last_i=z, rounds=z, qb=zs, qe=zs, il=zs, isz=zs, n=z, nfull=z)
    if p3_seeds:
        zp = torch.zeros((B, p3_seeds), dtype=i64, device=dev)
        pidx = torch.arange(p3_seeds, dtype=i64, device=dev)[None, :]
        st.update(px=z, pi=z, pk=z, pl=z, ps=z,
                  pneed=torch.ones(B, dtype=torch.bool, device=dev),
                  pdone=lens <= 0, pqb=zp, pqe=zp, pil=zp, pisz=zp,
                  pn=z, pnfull=z)

    def body(st):
        mode = st["mode"]
        is_fwd = mode == M_FWD
        is_bwd = mode == M_BWD
        ip = st["i"]
        o = {}
        if p3_seeds:
            p_init = st["pneed"] & ~st["pdone"]
            px = st["px"]
            pc0 = torch.where(p_init, rd(px), 4)
            pc0c = pc0.clamp(max=3)
            p_ok0 = p_init & (pc0 < 4)
            p_skip0 = p_init & ~p_ok0
            pk = torch.where(p_ok0, L2[pc0c] + 1, st["pk"])
            pl = torch.where(p_ok0, L2[3 - pc0c] + 1, st["pl"])
            ps = torch.where(p_ok0, L2[pc0c + 1] - L2[pc0c], st["ps"])
            pi = torch.where(p_ok0, px + 1, st["pi"])
            px = torch.where(p_skip0, px + 1, px)
            pneed = st["pneed"] & ~p_ok0
            p_ext = ~pneed & ~st["pdone"]
        ch = torch.where((is_fwd & (ip < lens)) | (is_bwd & (ip >= 0)),
                         rd(ip), 4)
        ch_ok = ch < 4
        Ain = torch.where(is_fwd, st["l"], st["bk"])
        Bin = torch.where(is_fwd, st["k"], st["bl"])
        Sin = torch.where(is_fwd, st["s"], st["bs"])
        K4, L4, S4 = bi_extend_back(fm, Ain, Bin, Sin)
        if count_work:
            ext_any = is_fwd | is_bwd
            count(ext_any, Ain, Sin)

        if p3_seeds:
            K4p, L4p, S4p = bi_extend_back(fm, pl, pk, ps)
            pch = torch.where(p_ext & (pi < lens), rd(pi), 4)
            pch_ok = pch < 4
            if count_work:
                count(p_ext & pch_ok, pl, ps)
                ext_any = ext_any | (p_ext & pch_ok)
            pcc = (3 - pch).clamp(0, 3)
            pnk = _take4(L4p, pcc)
            pnl = _take4(K4p, pcc)
            pns = _take4(S4p, pcc)
            p_hit = p_ext & pch_ok & (pns < p3_max_intv) \
                & (pi - px >= min_seed_len)
            p_bad = p_ext & ~pch_ok
            p_emit = p_hit & (pns > 0)
            p_can = p_emit & (st["pn"] < p3_seeds)
            p_hot = p_can[:, None] & (pidx == st["pn"][:, None])
            o["pqb"] = torch.where(p_hot, px[:, None], st["pqb"])
            o["pqe"] = torch.where(p_hot, (pi + 1)[:, None], st["pqe"])
            o["pil"] = torch.where(p_hot, pnk[:, None], st["pil"])
            o["pisz"] = torch.where(p_hot, pns[:, None], st["pisz"])
            o["pn"] = st["pn"] + p_can.to(i64)
            o["pnfull"] = st["pnfull"] + (p_emit & ~p_can).to(i64)
            p_restart = p_hit | p_bad
            p_adv = p_ext & ~p_restart
            o["pk"] = torch.where(p_adv, pnk, pk)
            o["pl"] = torch.where(p_adv, pnl, pl)
            o["ps"] = torch.where(p_adv, pns, ps)
            o["px"] = torch.where(p_restart, pi + 1, px)
            o["pneed"] = pneed | p_restart
            o["pi"] = torch.where(p_adv, pi + 1, pi)
            o["pdone"] = st["pdone"] | (o["pneed"] & (o["px"] >= lens))

        cc = torch.where(is_fwd, (3 - ch).clamp(0, 3), ch.clamp(max=3))
        nk = torch.where(is_fwd, _take4(L4, cc), _take4(K4, cc))
        nl = torch.where(is_fwd, _take4(K4, cc), _take4(L4, cc))
        ns = _take4(S4, cc)

        if count_work:
            work["rounds"] = work["rounds"] + ext_any.to(i64)

        # FWD lanes
        f_ok = is_fwd & ch_ok
        changed = f_ok & (ns != st["s"])
        die = changed & (ns < min_intv)
        hit_end = is_fwd & ~ch_ok
        push = changed | hit_end
        hot_p = push[:, None] & (cidx == (st["sn"] % C)[:, None])
        sk = torch.where(hot_p, st["k"][:, None], st["sk"])
        sl = torch.where(hot_p, st["l"][:, None], st["sl"])
        ss = torch.where(hot_p, st["s"][:, None], st["ss"])
        se = torch.where(hot_p, st["end"][:, None], st["se"])
        sn = st["sn"] + push.to(i64)
        adv = f_ok & ~die
        k = torch.where(adv, nk, st["k"])
        l = torch.where(adv, nl, st["l"])
        s = torch.where(adv, ns, st["s"])
        end = torch.where(adv, ip + 1, st["end"])
        fwd_dead = die | hit_end
        nx = torch.where(fwd_dead, end, st["nx"])

        # BWD lanes
        b_die = is_bwd & (~ch_ok | (ns < min_intv))
        b_adv = is_bwd & ~b_die
        e_start = ip + 1
        want = b_die & (st["be"] - e_start >= min_seed_len) \
            & (e_start < st["last_i"] + 1)
        emit = want & (st["n"] < max_seeds)
        hot_e = emit[:, None] & (sidx == st["n"][:, None])
        qb = torch.where(hot_e, e_start[:, None], st["qb"])
        qe = torch.where(hot_e, st["be"][:, None], st["qe"])
        il = torch.where(hot_e, st["bk"][:, None], st["il"])
        isz = torch.where(hot_e, st["bs"][:, None], st["isz"])
        n = st["n"] + emit.to(i64)
        nfull = st["nfull"] + (want & ~emit).to(i64)
        last_i = torch.where(emit, ip, st["last_i"])

        bj1 = st["bj"] - 1
        bwd_done = b_die & ((bj1 < 0) | (bj1 < sn - C))
        to_entry = b_die & ~bwd_done
        rounds = st["rounds"] + bwd_done.to(i64)
        x = torch.where(bwd_done, nx, st["x"])
        i = torch.where(is_fwd | to_entry,
                        torch.where(f_ok & ~fwd_dead, ip + 1, st["x"] - 1),
                        torch.where(b_adv, ip - 1, ip))
        bj = torch.where(fwd_dead, sn - 1, torch.where(b_die, bj1, st["bj"]))
        need_load = fwd_dead | to_entry
        slot = (bj.clamp(min=0) % C)[:, None]
        bk = torch.where(need_load, sk.gather(1, slot)[:, 0],
                         torch.where(b_adv, nk, st["bk"]))
        bl = torch.where(need_load, sl.gather(1, slot)[:, 0],
                         torch.where(b_adv, nl, st["bl"]))
        bs = torch.where(need_load, ss.gather(1, slot)[:, 0],
                         torch.where(b_adv, ns, st["bs"]))
        be = torch.where(need_load, se.gather(1, slot)[:, 0], st["be"])
        last_i = torch.where(fwd_dead, torch.full_like(last_i, 2**30),
                             last_i)
        mode = torch.where(fwd_dead, torch.full_like(mode, M_BWD),
                           torch.where(bwd_done,
                                       torch.where(rounds >= max_rounds,
                                                   M_DONE, M_INIT), mode))

        # INIT fold-in: start the next round in the same step
        is_init = mode == M_INIT
        past = x >= lens
        c0 = torch.where(is_init & ~past, rd(x), 4)
        c0c = c0.clamp(max=3)
        s0 = L2[c0c + 1] - L2[c0c]
        ok0 = is_init & ~past & (c0 < 4) & (s0 >= min_intv) & (s0 > 0)
        skip = is_init & ~past & ~ok0
        x = torch.where(skip, x + 1, x)
        rounds = rounds + skip.to(i64)
        mode = torch.where(is_init & past, M_DONE,
                           torch.where(ok0, M_FWD,
                                       torch.where(skip & (rounds >= max_rounds),
                                                   M_DONE, mode)))
        o.update(
            mode=mode, x=x, nx=nx,
            i=torch.where(ok0, x + 1, i),
            k=torch.where(ok0, L2[c0c] + 1, k),
            l=torch.where(ok0, L2[3 - c0c] + 1, l),
            s=torch.where(ok0, s0, s),
            end=torch.where(ok0, x + 1, end),
            sn=torch.where(ok0, 0, sn),
            sk=sk, sl=sl, ss=ss, se=se, bj=bj, bk=bk, bl=bl, bs=bs, be=be,
            last_i=last_i, rounds=rounds, qb=qb, qe=qe, il=il, isz=isz,
            n=n, nfull=nfull)
        return o

    for _ in range(step_cap):
        busy = st["mode"] != M_DONE
        if p3_seeds:
            busy = busy | ~st["pdone"]
        with profiling.sync("smem.busy"):
            busy_any = bool(busy.any())
        if not busy_any:
            break
        if count_work:
            work["steps"] = work["steps"] + busy.to(i64)
        st = body(st)

    i32 = torch.int32
    rk = i64 if fm.wide else i32

    def sz32(v):
        return v.clamp(max=I32_MAX).to(i32)

    truncated = (st["mode"] != M_DONE).to(i64)
    out = dict(qbeg=st["qb"].to(i32), qend=st["qe"].to(i32),
               intv_l=st["il"].to(rk), intv_sz=sz32(st["isz"]),
               n_seeds=st["n"].to(i32),
               n_dropped=(st["nfull"] + truncated).to(i32))
    if p3_seeds:
        out.update(p3_qbeg=st["pqb"].to(i32), p3_qend=st["pqe"].to(i32),
                   p3_intv_l=st["pil"].to(rk),
                   p3_intv_sz=sz32(st["pisz"]), p3_n=st["pn"].to(i32))
    if count_work:
        out.update(work)
    return out


def smem_machine(fm: DeviceFMIndex, reads, lens, x0, min_intv, active,
                 max_seeds: int, min_seed_len: int, C: int,
                 max_rounds: int, step_cap: int,
                 p3_seeds: int = 0, p3_max_intv: int = 20):
    """The SMEM machine of :func:`_smem_machine`: kernel K2 on CUDA
    tensors, the plain version on CPU tensors."""
    run = fm_cuda.smem_machine_cuda if reads.is_cuda else _smem_machine
    return run(fm, reads, lens, x0, min_intv, active, max_seeds,
               min_seed_len, C, max_rounds, step_cap, p3_seeds, p3_max_intv)


def smem_collect(fm: DeviceFMIndex, reads, lens, max_seeds: int = 16,
                 min_seed_len: int = 19, max_prev: int = 8,
                 p3_seeds: int = 0, p3_max_intv: int = 20):
    """All bidirectional SMEMs of a read batch (bwa's first
    ``mem_collect_intv`` pass), with the optional third pass fused in."""
    B, L = reads.shape
    dev = reads.device
    return smem_machine(
        fm, reads, lens,
        x0=torch.zeros(B, dtype=torch.int32, device=dev),
        min_intv=torch.ones(B, dtype=torch.int32, device=dev),
        active=lens > 0, max_seeds=max_seeds, min_seed_len=min_seed_len,
        C=max_prev, max_rounds=L, step_cap=4 * L + 16,
        p3_seeds=p3_seeds, p3_max_intv=p3_max_intv)


def smem_reseed(fm: DeviceFMIndex, reads, lens, qb, qe, occ, active,
                min_seed_len: int = 19, max_prev: int = 8):
    """bwa's second ``mem_collect_intv`` pass: ``bwt_smem1`` from each
    seed midpoint with min_intv = occ + 1, keeping the longest
    qualifying SMEM.  Returns (qbeg2, qend2, intv_l2, intv_sz2) in the
    machine's dtypes, zeros where nothing qualified."""
    L = reads.shape[1]
    R = 4
    mid = (qb + qe) // 2
    acc = smem_machine(fm, reads, lens, x0=mid, min_intv=occ + 1,
                       active=active, max_seeds=R,
                       min_seed_len=min_seed_len, C=max_prev,
                       max_rounds=1, step_cap=2 * L + 8)
    slen = acc["qend"] - acc["qbeg"]
    valid = torch.arange(R, device=reads.device)[None, :] \
        < acc["n_seeds"][:, None]
    pick = torch.argmax(torch.where(valid, slen, -1), dim=1)[:, None]
    got = valid.gather(1, pick)[:, 0] & active.bool()
    return tuple(torch.where(got, acc[k].gather(1, pick)[:, 0], 0)
                 for k in ("qbeg", "qend", "intv_l", "intv_sz"))
