"""2-bit reference packing with bwa-compatible N handling (counterpart of
seqlib_tpu/index/pack.py).

Ambiguous bases are replaced by ``lrand48() & 3`` under ``srand48(11)``
(the ``bwa index`` convention), one draw per ambiguous base in sequence
order, and N runs are recorded as holes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.seq import NT4_TABLE

_LRAND48_A = 0x5DEECE66D
_LRAND48_C = 0xB
_LRAND48_M = 1 << 48


class Lrand48:
    """Exact replica of glibc's lrand48/srand48 stream."""

    def __init__(self, seed: int = 11):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def next(self) -> int:
        self.x = (_LRAND48_A * self.x + _LRAND48_C) % _LRAND48_M
        return self.x >> 17


@dataclass
class Annotation:
    """One reference sequence's annotation (bntann1_t equivalent)."""
    name: str
    offset: int
    length: int
    n_amb: int = 0
    gi: int = 0
    anno: str = "(null)"


@dataclass
class Hole:
    """One ambiguous-base run (bntamb1_t equivalent)."""
    offset: int
    length: int
    amb: str = "N"


@dataclass
class PackedReference:
    """Forward-strand nt4 codes after N substitution + annotations."""
    codes: np.ndarray
    anns: list[Annotation]
    holes: list[Hole]
    seed: int = 11

    @property
    def l_pac(self) -> int:
        return int(self.codes.size)


def pack_sequences(seqs: list[tuple[str, str]], seed: int = 11
                   ) -> PackedReference:
    """Pack (name, sequence) pairs into forward nt4 codes."""
    rng = Lrand48(seed)
    anns: list[Annotation] = []
    holes: list[Hole] = []
    parts: list[np.ndarray] = []
    offset = 0
    for name, seq in seqs:
        if not name or not seq:
            raise ValueError("pack_sequences: empty name or sequence")
        codes = NT4_TABLE[np.frombuffer(seq.upper().encode(),
                                        dtype=np.uint8)].copy()
        n_amb = 0
        amb_idx = np.flatnonzero(codes > 3)
        if amb_idx.size:
            prev = -2
            for i in amb_idx:
                i = int(i)
                if i == prev + 1 and holes and seq[i].upper() == holes[-1].amb:
                    holes[-1].length += 1
                else:
                    holes.append(Hole(offset + i, 1, seq[i].upper()))
                    n_amb += 1
                codes[i] = rng.next() & 3
                prev = i
        anns.append(Annotation(name, offset, len(seq), n_amb))
        offset += len(seq)
        parts.append(codes)
    return PackedReference(np.concatenate(parts) if parts
                           else np.zeros(0, np.uint8), anns, holes, seed)


def pac_bytes(codes: np.ndarray) -> bytes:
    """nt4 codes (all < 4) -> bwa .pac byte layout (base i in bits
    ``(~i & 3) * 2`` of byte ``i >> 2``: first base in the top 2 bits)."""
    n = codes.size
    padded = np.zeros(((n + 3) // 4) * 4, dtype=np.uint8)
    padded[:n] = codes
    q = padded.reshape(-1, 4)
    return ((q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2)
            | q[:, 3]).astype(np.uint8).tobytes()


def codes_from_pac(pac: bytes | np.ndarray, l_pac: int) -> np.ndarray:
    """Inverse of :func:`pac_bytes`."""
    arr = np.frombuffer(pac, dtype=np.uint8) if isinstance(pac, bytes) \
        else np.asarray(pac, dtype=np.uint8)
    out = np.empty(arr.size * 4, dtype=np.uint8)
    out[0::4] = (arr >> 6) & 3
    out[1::4] = (arr >> 4) & 3
    out[2::4] = (arr >> 2) & 3
    out[3::4] = arr & 3
    return out[:l_pac]


def both_strands(codes: np.ndarray) -> np.ndarray:
    """Forward + reverse-complement concatenation (the BWT text)."""
    return np.concatenate([codes, (3 - codes)[::-1]])
