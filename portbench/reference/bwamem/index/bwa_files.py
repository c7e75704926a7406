# Frozen copy of seqlib_tpu_torch/index/bwa_files.py for the benchmark's reference
# (plain PyTorch path only): later changes to the port do not reach it.
"""bwa's on-disk index files: .pac, .ann, .amb, .bwt and .sa
(counterpart of seqlib_tpu/index/bwa_files.py).

Byte for byte the files ``bwa index`` writes: 64-bit integer fields,
occurrence counts interleaved with the BWT every OCC_INTERVAL = 128
bases in .bwt, and the suffix array sampled by rank every SA_INTERVAL =
32 in .sa.
"""

from __future__ import annotations

import struct

import numpy as np

from .pack import Annotation, Hole, PackedReference, codes_from_pac, \
    pac_bytes

OCC_INTERVAL = 0x80   # 128 bases between occurrence checkpoints
SA_INTERVAL = 32


# ---------------------------------------------------------------------------
# .pac
# ---------------------------------------------------------------------------

def write_pac(path: str, codes: np.ndarray) -> None:
    """2-bit bases, then a 0 byte when ``l_pac % 4 == 0``, then the byte
    ``l_pac % 4``."""
    l_pac = codes.size
    with open(path, "wb") as fh:
        fh.write(pac_bytes(codes))
        if l_pac % 4 == 0:
            fh.write(b"\x00")
        fh.write(bytes([l_pac % 4]))


def read_pac(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        data = fh.read()
    mod = data[-1]
    if mod == 0:
        body = data[:-2]
        l_pac = len(body) * 4
    else:
        body = data[:-1]
        l_pac = (len(body) - 1) * 4 + mod
    return codes_from_pac(body, l_pac)


# ---------------------------------------------------------------------------
# .ann / .amb (text)
# ---------------------------------------------------------------------------

def write_ann(path: str, ref: PackedReference) -> None:
    with open(path, "w") as fh:
        fh.write(f"{ref.l_pac} {len(ref.anns)} {ref.seed}\n")
        for a in ref.anns:
            fh.write(f"{a.gi} {a.name} {a.anno}\n")
            fh.write(f"{a.offset} {a.length} {a.n_amb}\n")


def write_amb(path: str, ref: PackedReference) -> None:
    with open(path, "w") as fh:
        fh.write(f"{ref.l_pac} {len(ref.anns)} {len(ref.holes)}\n")
        for h in ref.holes:
            fh.write(f"{h.offset} {h.length} {h.amb}\n")


def read_ann(path: str) -> tuple[int, int, list[Annotation]]:
    """-> (l_pac, seed, annotations)."""
    with open(path) as fh:
        l_pac, n_seqs, seed = (int(x) for x in fh.readline().split())
        anns = []
        for _ in range(n_seqs):
            parts = fh.readline().split(None, 2)
            gi, name = int(parts[0]), parts[1]
            anno = parts[2].strip() if len(parts) > 2 else "(null)"
            off, ln, n_amb = (int(x) for x in fh.readline().split())
            anns.append(Annotation(name, off, ln, n_amb, gi, anno))
    return l_pac, seed, anns


def read_amb(path: str) -> list[Hole]:
    with open(path) as fh:
        _l_pac, _n, n_holes = (int(x) for x in fh.readline().split())
        holes = []
        for _ in range(n_holes):
            off, ln, ch = fh.readline().split()
            holes.append(Hole(int(off), int(ln), ch))
    return holes


# ---------------------------------------------------------------------------
# .bwt: primary, L2[1..4], the interleaved counts and BWT words
# ---------------------------------------------------------------------------

def interleave_occ(bwt_codes: np.ndarray) -> np.ndarray:
    """2-bit BWT with occurrence checkpoints every OCC_INTERVAL bases.

    Per 128-base block: the 4 uint64 counts of each code before the
    block (as 8 uint32 words), then 8 uint32 words of 16 bases each,
    first base in the top 2 bits.  A last block of 4 counts (the
    totals) follows."""
    n = bwt_codes.size
    nb = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    padded = np.zeros(nb * OCC_INTERVAL, dtype=np.uint8)
    padded[:n] = bwt_codes
    blocks = padded.reshape(nb, OCC_INTERVAL)
    valid = np.arange(nb * OCC_INTERVAL).reshape(nb, OCC_INTERVAL) < n
    onehot = (blocks[..., None] == np.arange(4)) & valid[..., None]
    cum = np.zeros((nb + 1, 4), dtype=np.uint64)
    np.cumsum(onehot.sum(axis=1).astype(np.uint64), axis=0, out=cum[1:])
    q = padded.reshape(nb, 8, 16).astype(np.uint32)
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    words = (q << shifts).sum(axis=2, dtype=np.uint32)
    out = np.empty(nb * 16 + 8, dtype=np.uint32)
    body = out[:nb * 16].reshape(nb, 16)
    body[:, 0:8] = cum[:-1].view(np.uint32).reshape(nb, 8)
    body[:, 8:16] = words
    out[nb * 16:] = cum[-1].view(np.uint32)
    return out


def deinterleave_occ(words: np.ndarray, seq_len: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`interleave_occ` -> (bwt codes, uint64 [nb, 4]
    checkpoints; the totals block is not among them)."""
    nb = (seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
    body = words[:nb * 16].reshape(nb, 16)
    cps = body[:, 0:8].copy().view(np.uint64).reshape(nb, 4)
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    codes = ((body[:, 8:16, None] >> shifts) & 3).astype(np.uint8)
    return codes.reshape(-1)[:seq_len], cps


def write_bwt(path: str, primary: int, L2: np.ndarray,
              interleaved: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", primary))
        fh.write(np.asarray(L2[1:5], dtype="<u8").tobytes())
        fh.write(interleaved.astype("<u4").tobytes())


def read_bwt(path: str) -> tuple[int, np.ndarray, np.ndarray]:
    """-> (primary, uint64 L2 [5], the interleaved uint32 words)."""
    with open(path, "rb") as fh:
        primary = struct.unpack("<Q", fh.read(8))[0]
        l2tail = np.frombuffer(fh.read(32), dtype="<u8")
        words = np.frombuffer(fh.read(), dtype="<u4")
    L2 = np.zeros(5, dtype=np.uint64)
    L2[1:5] = l2tail
    return primary, L2, words.astype(np.uint32)


# ---------------------------------------------------------------------------
# .sa: primary, L2[1..4], sa_intv, seq_len, sa[1..n_sa-1]
# ---------------------------------------------------------------------------

def write_sa(path: str, primary: int, L2: np.ndarray, sa_intv: int,
             seq_len: int, sa_samples: np.ndarray) -> None:
    """``sa_samples[0]`` (rank 0, the sentinel's placeholder) is not
    written: bwa dumps ``sa + 1``."""
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", primary))
        fh.write(np.asarray(L2[1:5], dtype="<u8").tobytes())
        fh.write(struct.pack("<QQ", sa_intv, seq_len))
        fh.write(sa_samples[1:].astype("<u8").tobytes())


def read_sa(path: str) -> tuple[int, int, int, np.ndarray]:
    """-> (primary, sa_intv, seq_len, uint64 samples with [0] all ones).

    The samples are those of ranks 0, sa_intv, 2 sa_intv, ... up to
    seq_len: ``(seq_len + sa_intv) // sa_intv`` of them, as bwa's
    ``bwt_restore_sa`` counts."""
    with open(path, "rb") as fh:
        primary = struct.unpack("<Q", fh.read(8))[0]
        fh.read(32)  # L2, as in .bwt
        sa_intv, seq_len = struct.unpack("<QQ", fh.read(16))
        body = np.frombuffer(fh.read(), dtype="<u8")
    n_sa = (seq_len + sa_intv) // sa_intv
    if body.size != n_sa - 1:
        raise ValueError(f"{path}: {body.size} suffix-array samples, "
                         f"expected {n_sa - 1}")
    sa = np.empty(n_sa, dtype=np.uint64)
    sa[0] = np.uint64(0xFFFFFFFFFFFFFFFF)
    sa[1:] = body
    return primary, int(sa_intv), int(seq_len), sa
