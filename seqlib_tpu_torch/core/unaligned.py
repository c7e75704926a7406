"""UnalignedSequence: a name/sequence/quality record (counterpart of
seqlib_tpu/core/unaligned.py)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class UnalignedSequence:
    name: str = ""
    seq: str = ""
    qual: str = ""
    strand: str = "*"
    com: str = ""  # comment

    def to_fastq(self) -> str:
        """FASTQ block ("I" qualities when there are none)."""
        qual = self.qual if self.qual else "I" * len(self.seq)
        return f"@{self.name}\n{self.seq}\n+\n{qual}\n"

    def to_fasta(self) -> str:
        return f">{self.name}\n{self.seq}\n"


UnalignedSequenceVector = list
