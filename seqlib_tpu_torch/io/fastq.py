"""FastqReader: gzip-aware FASTA/FASTQ streaming (counterpart of
seqlib_tpu/io/fastq.py).

Parity target: SeqLib/SeqLib/FastqReader.h:22-63 (kseq-based)
— yields UnalignedSequence with name/seq/qual.
"""

from __future__ import annotations

import gzip

from ..core.unaligned import UnalignedSequence


def _open_text(path: str):
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "r")


class FastqReader:
    """Streams FASTA or FASTQ records (format auto-detected)."""

    def __init__(self, path: str | None = None):
        self._fh = None
        self._pending_header: str | None = None
        if path is not None:
            if not self.open(path):
                raise IOError(f"FastqReader: cannot open {path}")

    def open(self, path: str) -> bool:
        try:
            self._fh = _open_text(path)
            return True
        except OSError:
            return False

    def get_next_sequence(self) -> UnalignedSequence | None:
        if self._fh is None:
            return None
        if self._pending_header is not None:
            hdr, self._pending_header = self._pending_header, None
        else:
            hdr = self._fh.readline()
            while hdr and not hdr.strip():
                hdr = self._fh.readline()
        if not hdr:
            return None
        hdr = hdr.rstrip("\n")
        if hdr.startswith("@"):  # FASTQ
            name = hdr[1:].split()[0] if len(hdr) > 1 else ""
            com = hdr[1:][len(name):].strip()
            seq = self._fh.readline().rstrip("\n")
            self._fh.readline()  # '+'
            qual = self._fh.readline().rstrip("\n")
            return UnalignedSequence(name, seq, qual, com=com)
        if hdr.startswith(">"):  # FASTA (multi-line)
            name = hdr[1:].split()[0] if len(hdr) > 1 else ""
            com = hdr[1:][len(name):].strip()
            parts = []
            while True:
                line = self._fh.readline()
                if not line:
                    break
                if line.startswith(">") or line.startswith("@"):
                    self._pending_header = line.rstrip("\n")
                    break
                parts.append(line.strip())
            return UnalignedSequence(name, "".join(parts), "", com=com)
        raise ValueError(f"FastqReader: unexpected line {hdr!r}")

    def __iter__(self):
        return self

    def __next__(self):
        rec = self.get_next_sequence()
        if rec is None:
            if self._fh:
                self._fh.close()
            raise StopIteration
        return rec

    GetNextSequence = get_next_sequence
    Open = open
