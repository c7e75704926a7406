"""Device k-mer pipeline (counterpart of seqlib_tpu/ops/kmer.py):
packing, canonicalisation, sort-based counting, table lookup and the
lockstep spectrum walk of BFC error correction, in plain PyTorch.

A k-mer (k <= 32) is one int64 key.  Its value is the usual 2-bit
packing (A=0 C=1 G=2 T=3, first base most significant), the uint64
that ``seqlib_tpu``'s (hi, lo) int32 pairs spell, shifted down by
``2^63`` when k = 32: that is the uint64 with bit 63 flipped
(``to_uint64`` maps it back), so signed int64 order is the unsigned order the JAX package
sorts by.  For k <= 31 a key is under 2^62 and the shift is 0.  No
operation here overflows int64: a key is built by multiply-add from a
first digit of ``c - 2`` when k = 32, and rolls keep the carried bases
below 2^62 before they scale them.

Invalid windows (one holding an N, or reaching past the read's
length) are dropped before counting, so no sentinel enters a table;
their keys are still computed (from ``code & 3``, as the JAX package
does) and looked up.  Lookups search the table with one appended key
of ``2^63 - 1`` (count 0), which no canonical k-mer equals: the
canonical form of the all-T 32-mer is the all-A one.

The walk (``correct_reads_device``) runs every row of a batch in
lockstep: each step scores the four candidate bases of one column as
one ``[B, 4]`` key tensor.  It runs B and the columns unpadded: rows
are independent and a column at or past a row's length changes
nothing in it.
"""

from __future__ import annotations

import numpy as np
import torch

INT64_MAX = (1 << 63) - 1


def to_uint64(keys, k: int) -> np.ndarray:
    """int64 keys (numpy) -> the uint64 k-mer values they stand for."""
    u = np.asarray(keys, np.int64).view(np.uint64)
    return u ^ np.uint64(1 << 63) if k == 32 else u.copy()


def _pack(digits, k: int) -> torch.Tensor:
    """Key of k base tensors (int64, 0-3, most significant first)."""
    out = None
    for j, c in enumerate(digits):
        if out is None:
            out = c - 2 if k == 32 else c.clone()
        else:
            out.mul_(4).add_(c)
    return out


def _roll_fwd(key: torch.Tensor, b, k: int) -> torch.Tensor:
    """Append base b to a key (drop the oldest base)."""
    rest = key & ((1 << (2 * k - 2)) - 1)
    if k == 32:
        rest = rest - (1 << 61)
    return rest * 4 + b


def _roll_bwd(key: torch.Tensor, b, k: int) -> torch.Tensor:
    """Prepend base b to a key (drop the newest base)."""
    if k == 32:
        low = ((key >> 2) & ((1 << 62) - 1)) ^ (1 << 61)
        return low + (b - 2) * (1 << 62)
    return (key >> 2) + b * (1 << (2 * k - 2))


def pack_kmers(reads: torch.Tensor, lens: torch.Tensor, k: int):
    """All k-mers of a read batch: keys int64 [B, L-k+1] and validity.

    reads [B, L] nt4 codes (4 = N/pad); lens [B]."""
    B, L = reads.shape
    n = L - k + 1
    if n <= 0:
        return (torch.zeros((B, 0), dtype=torch.int64, device=reads.device),
                torch.zeros((B, 0), dtype=torch.bool, device=reads.device))
    c = (reads & 3).long()
    key = _pack([c[:, j:j + n] for j in range(k)], k)
    bad = torch.nn.functional.pad((reads > 3).int().cumsum(1), (1, 0))
    nbad = bad[:, k:k + n] - bad[:, :n]
    pos = torch.arange(n, device=reads.device)
    valid = (nbad == 0) & (pos[None, :] + k <= lens[:, None])
    return key, valid


def revcomp_kmers(key: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed k-mers."""
    def digits():              # lowest base first, one tensor at a time
        for j in range(k):
            c = (key >> (2 * j)) & 3
            yield 3 - (c ^ 2 if k == 32 and j == 31 else c)
    return _pack(digits(), k)


def canonical_kmers_device(reads: torch.Tensor, lens: torch.Tensor, k: int):
    """min(k-mer, reverse complement) keys [B, L-k+1] and validity."""
    key, valid = pack_kmers(reads, lens, k)
    return torch.minimum(key, revcomp_kmers(key, k)), valid


def count_kmers_device(keys: torch.Tensor, valid: torch.Tensor):
    """Sorted unique keys of the valid windows and their counts
    (int64), sort plus unique counts."""
    return torch.unique(keys[valid], sorted=True, return_counts=True)


class Table:
    """A sorted key table prepared for lookups: the keys with one
    appended ``INT64_MAX`` (count 0), so a search never runs off the
    end."""

    def __init__(self, keys: torch.Tensor, counts: torch.Tensor):
        dev = keys.device
        self.keys = torch.cat([keys, torch.full((1,), INT64_MAX,
                                                dtype=torch.int64,
                                                device=dev)])
        self.counts = torch.cat([counts.long(),
                                 torch.zeros(1, dtype=torch.int64,
                                             device=dev)])

    def lookup(self, q: torch.Tensor) -> torch.Tensor:
        idx = torch.searchsorted(self.keys, q)
        return torch.where(self.keys[idx] == q, self.counts[idx], 0)


def lookup_kmers_device(keys: torch.Tensor, counts: torch.Tensor,
                        q: torch.Tensor) -> torch.Tensor:
    """Counts of query keys in a sorted table (0 where absent)."""
    return Table(keys, counts).lookup(q.contiguous())


def weak_reads_device(reads: torch.Tensor, lens: torch.Tensor,
                      keys: torch.Tensor, counts: torch.Tensor, k: int,
                      min_cov: int) -> torch.Tensor:
    """[B] bool: the read has at least one valid window whose count is
    under min_cov — the cheap pre-scan that gates the walk."""
    can, valid = canonical_kmers_device(reads, lens, k)
    cnt = lookup_kmers_device(keys, counts, can)
    return (valid & (cnt < min_cov)).any(1)


def correct_reads_device(reads: torch.Tensor, lens: torch.Tensor,
                         keys: torch.Tensor, counts: torch.Tensor, k: int,
                         min_cov: int):
    """Lockstep spectrum-walk error correction (BFC ``kmer_correct``'s
    role), the JAX package's ``correct_reads_device`` exactly.

    From each read's first solid window ``a`` (count >= min_cov), walk
    right from column a + k, then left from column a - 1 over the
    forward walk's output; where the k-mer ending (starting) at a
    column is weak, or the column is an N, put in the first base of
    the strongest solid extension.  reads [B, L] nt4 codes, lens [B];
    returns (codes uint8 [B, L], n_changed int32 [B]).  Reads with no
    solid window come back unchanged.
    """
    B, L = reads.shape
    dev = reads.device
    codes = torch.where(reads < 4, reads, 4).long()
    if B == 0 or L < k:
        return codes.to(torch.uint8), torch.zeros(B, dtype=torch.int32,
                                                    device=dev)
    table = Table(keys, counts)
    can, valid = canonical_kmers_device(reads, lens, k)
    solid = (table.lookup(can) >= min_cov) & valid
    has_anchor = solid.any(1)
    n = solid.shape[1]
    pos_n = torch.arange(n, device=dev)
    a = torch.where(solid, pos_n, n).amin(1)               # first solid
    lens = lens.long()
    pos = torch.arange(L, device=dev)[None, :]
    fwd_on = has_anchor[:, None] & (pos >= (a + k)[:, None]) \
        & (pos < lens[:, None])
    bwd_on = has_anchor[:, None] & (pos < a[:, None]) \
        & (pos + k < lens[:, None])
    a_max = int(torch.where(has_anchor, a, 0).max())
    a_min = int(torch.where(has_anchor, a, L).min())
    l_max = int(torch.where(has_anchor, lens, 0).max())
    b4 = torch.arange(4, device=dev)[None, :]
    orig = codes.clone()

    def step(p, fs, rs, on, roll_f, roll_r):
        o = codes[:, p]
        oc = o.clamp(max=3)
        o4 = o == 4
        cf = roll_f(fs[:, None], b4, k)
        cr = roll_r(rs[:, None], 3 - b4, k)
        cnt = table.lookup(torch.minimum(cf, cr))          # [B, 4]
        best_cnt, best_b = cnt.max(1)                       # first max
        weak = (cnt.gather(1, oc[:, None])[:, 0] < min_cov) | o4
        sub = on[:, p] & weak & (best_cnt >= min_cov) \
            & ((best_b != oc) | o4)
        codes[:, p] = torch.where(sub, best_b, o)
        walk = torch.where(sub, best_b, oc)[:, None]
        return cf.gather(1, walk)[:, 0], cr.gather(1, walk)[:, 0]

    z = torch.zeros(B, dtype=torch.int64, device=dev)
    # forward: the state after column p covers [p-k+1, p+1); its first
    # correcting column (a + k) needs columns from a on
    fs, rs = z, z
    for p in range(a_min, l_max):
        fs, rs = step(p, fs, rs, fwd_on, _roll_fwd, _roll_bwd)
    # backward: the state before column p covers [p+1, p+k+1); its
    # first correcting column (a - 1) needs columns up to a - 1 + k
    fs, rs = z, z
    for p in range(min(a_max - 1 + k, l_max - 1), -1, -1) if a_max else ():
        fs, rs = step(p, fs, rs, bwd_on, _roll_bwd, _roll_fwd)
    nchg = (codes != orig).sum(1, dtype=torch.int32)
    return codes.to(torch.uint8), nchg
