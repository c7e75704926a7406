# Frozen copy of seqlib_tpu_torch/core/cigar.py for the benchmark's reference
# (plain PyTorch path only): later changes to the port do not reach it.
"""Cigar / CigarField (counterpart of seqlib_tpu/core/cigar.py).

A Cigar is an ordered list of CigarFields with the standard BAM op codes
(``MIDNSHP=XB`` -> 0..9).
"""

from __future__ import annotations

import re

import numpy as np

CIGAR_OPS = "MIDNSHP=XB"
OP_TO_CODE = {c: i for i, c in enumerate(CIGAR_OPS)}

# which ops consume query / reference (SAM spec)
_QUERY_CONSUMERS = frozenset("MIS=X")
_REF_CONSUMERS = frozenset("MDN=X")

_CIGAR_RE = re.compile(r"([0-9]+)([MIDNSHPX=B])")


class CigarField:
    """One CIGAR element: op char + positive length."""

    __slots__ = ("_op", "_len")

    def __init__(self, op: str, length: int):
        if op not in OP_TO_CODE:
            raise ValueError(f"CigarField: invalid op {op!r}")
        if length <= 0:
            raise ValueError("CigarField: length must be positive")
        self._op = op
        self._len = int(length)

    @property
    def type(self) -> str:
        return self._op

    @property
    def length(self) -> int:
        return self._len

    def consumes_query(self) -> bool:
        return self._op in _QUERY_CONSUMERS

    def consumes_reference(self) -> bool:
        return self._op in _REF_CONSUMERS

    def __eq__(self, o):
        return (isinstance(o, CigarField) and self._op == o._op
                and self._len == o._len)

    def __hash__(self):
        return hash((self._op, self._len))

    def __repr__(self):
        return f"{self._len}{self._op}"


class Cigar:
    """Ordered list of CigarFields, built from nothing, a CIGAR string,
    another Cigar, or an iterable of CigarFields / (op, length) pairs."""

    def __init__(self, arg=None):
        self.fields: list[CigarField] = []
        if arg is None:
            return
        if isinstance(arg, str):
            self._parse(arg)
        elif isinstance(arg, Cigar):
            self.fields = list(arg.fields)
        else:
            for f in arg:
                if isinstance(f, CigarField):
                    self.fields.append(f)
                else:
                    op, ln = f
                    if isinstance(op, (int, np.integer)):
                        op = CIGAR_OPS[op]
                    self.fields.append(CigarField(op, ln))

    def _parse(self, cig: str) -> None:
        if cig in ("", "*"):
            return
        pos = 0
        for m in _CIGAR_RE.finditer(cig):
            if m.start() != pos:
                raise ValueError(f"Cigar: malformed CIGAR string {cig!r}")
            pos = m.end()
            self.fields.append(CigarField(m.group(2), int(m.group(1))))
        if pos != len(cig):
            raise ValueError(f"Cigar: malformed CIGAR string {cig!r}")

    @classmethod
    def from_arrays(cls, ops: np.ndarray, lens: np.ndarray) -> "Cigar":
        """From parallel op-code and length arrays."""
        c = cls()
        c.fields = [CigarField(CIGAR_OPS[int(o)], int(l))
                    for o, l in zip(ops, lens)]
        return c

    @classmethod
    def from_bam_encoded(cls, enc: np.ndarray) -> "Cigar":
        """From the BAM uint32 encoding: length << 4 | op code."""
        enc = np.asarray(enc, dtype=np.uint32)
        return cls.from_arrays(enc & 0xF, enc >> 4)

    def to_bam_encoded(self) -> np.ndarray:
        """BAM uint32 encoding: length << 4 | op code."""
        return np.array(
            [(f.length << 4) | OP_TO_CODE[f.type] for f in self.fields],
            dtype=np.uint32)

    def add(self, field: CigarField) -> None:
        self.fields.append(field)

    def num_query_consumed(self) -> int:
        """Bases of the query consumed (M/I/S/=/X)."""
        return sum(f.length for f in self.fields if f.consumes_query())

    def num_reference_consumed(self) -> int:
        """Bases of the reference consumed (M/D/N/=/X)."""
        return sum(f.length for f in self.fields if f.consumes_reference())

    def __len__(self):
        return len(self.fields)

    def __getitem__(self, i):
        return self.fields[i]

    def __iter__(self):
        return iter(self.fields)

    def __eq__(self, o):
        return isinstance(o, Cigar) and self.fields == o.fields

    def __str__(self):
        if not self.fields:
            return "*"  # SAM convention for empty
        return "".join(f"{f.length}{f.type}" for f in self.fields)

    def __repr__(self):
        return f"Cigar({self!s})"
