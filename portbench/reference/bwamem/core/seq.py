# Frozen copy of seqlib_tpu_torch/core/seq.py for the benchmark's reference
# (plain PyTorch path only): later changes to the port do not reach it.
"""Sequence encoding tables (counterpart of seqlib_tpu/core/seq.py).

* nt4 code: A=0 C=1 G=2 T=3, anything else 4 (N) — the alphabet of the
  FM-index and every DP kernel.
* nib code (BAM 4-bit): ``=ACMGRSVTWYHKDBN``, two bases per byte in a
  BAM record; ``ASCII_TO_NIB`` maps either case, anything else to 15;
  ``pack_nibbles`` / ``unpack_nibbles`` pack and unpack it, high nibble
  first.
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
NIB_TO_ASCII = np.frombuffer(SEQ_NT16_STR.encode(), dtype=np.uint8)
ASCII_TO_NIB = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(SEQ_NT16_STR):
    ASCII_TO_NIB[ord(_c)] = _i
    ASCII_TO_NIB[ord(_c.lower())] = _i

# nib -> nt4 (A, C, G, T nibbles to 0..3; every ambiguous code to 4)
NIB_TO_NT4 = np.full(16, 4, dtype=np.uint8)
NIB_TO_NT4[[1, 2, 4, 8]] = [0, 1, 2, 3]
NT4_TO_NIB = np.array([1, 2, 4, 8, 15], dtype=np.uint8)

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


def pack_nibbles(seq: str | bytes) -> bytes:
    """ASCII -> BAM 4-bit packed bytes, two bases a byte, high nibble
    first (an odd length pads the last low nibble with 0)."""
    if isinstance(seq, str):
        seq = seq.encode()
    nibs = ASCII_TO_NIB[np.frombuffer(seq, dtype=np.uint8)]
    if len(nibs) % 2:
        nibs = np.concatenate([nibs, np.zeros(1, dtype=np.uint8)])
    return ((nibs[0::2] << 4) | nibs[1::2]).tobytes()


def unpack_nibbles(data: bytes, length: int) -> str:
    """BAM 4-bit packed bytes -> ASCII sequence of ``length`` bases."""
    arr = np.frombuffer(data, dtype=np.uint8)
    nibs = np.empty(arr.size * 2, dtype=np.uint8)
    nibs[0::2] = arr >> 4
    nibs[1::2] = arr & 0xF
    return NIB_TO_ASCII[nibs[:length]].tobytes().decode()
