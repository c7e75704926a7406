"""Sequence encoding tables (counterpart of seqlib_tpu/core/seq.py).

* nt4 code: A=0 C=1 G=2 T=3, anything else 4 (N) — the alphabet of the
  FM-index and every DP kernel.
* nib code (BAM 4-bit): ``=ACMGRSVTWYHKDBN``, two bases per byte in a
  BAM record; ``ASCII_TO_NIB`` maps either case, anything else to 15.
* ``revcomp`` complements A/C/G/T (either case) and keeps every other
  byte, then reverses; ``revcomp_nt4`` does the same on nt4 codes.
"""

from __future__ import annotations

import numpy as np

NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    NT4_TABLE[_b] = _i
    NT4_TABLE[ord(chr(_b).lower())] = _i

SEQ_NT16_STR = "=ACMGRSVTWYHKDBN"
ASCII_TO_NIB = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(SEQ_NT16_STR):
    ASCII_TO_NIB[ord(_c)] = _i
    ASCII_TO_NIB[ord(_c.lower())] = _i

COMPLEMENT_TABLE = np.arange(256, dtype=np.uint8)
for _a, _b in [(b"A", b"T"), (b"C", b"G"), (b"G", b"C"), (b"T", b"A"),
               (b"a", b"t"), (b"c", b"g"), (b"g", b"c"), (b"t", b"a"),
               (b"N", b"N"), (b"n", b"n")]:
    COMPLEMENT_TABLE[_a[0]] = _b[0]


def encode_nt4(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> nt4 codes (uint8 array)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)]


def revcomp(seq: str) -> str:
    """Reverse complement of an ASCII sequence."""
    arr = np.frombuffer(seq.encode(), dtype=np.uint8)
    return COMPLEMENT_TABLE[arr][::-1].tobytes().decode()


NT4_TO_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)


def decode_nt4(codes: np.ndarray) -> str:
    """nt4 codes -> ASCII string (4 -> 'N')."""
    return NT4_TO_ASCII[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def revcomp_nt4(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in nt4 space: c -> 3-c for c<4, N stays N."""
    codes = np.asarray(codes, dtype=np.uint8)
    return np.where(codes < 4, 3 - codes, codes)[::-1]
