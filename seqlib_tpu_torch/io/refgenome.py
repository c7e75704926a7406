"""RefGenome: random access into a FASTA through its ``.fai``, and
``build_faidx``, which writes that index (counterpart of
seqlib_tpu/io/refgenome.py)."""

from __future__ import annotations

import os


def build_faidx(fa_path: str) -> str:
    """Create <fa>.fai (name, length, offset, linebases, linewidth)."""
    entries = []
    with open(fa_path, "rb") as fh:
        name = None
        length = 0
        offset = 0
        linebases = 0
        linewidth = 0
        first_line = True
        while True:
            pos = fh.tell()
            line = fh.readline()
            if not line:
                break
            if line.startswith(b">"):
                if name is not None:
                    entries.append((name, length, offset, linebases,
                                    linewidth))
                name = line[1:].split()[0].decode()
                length = 0
                offset = fh.tell()
                first_line = True
            else:
                bases = len(line.rstrip(b"\r\n"))
                length += bases
                if first_line and bases:
                    linebases = bases
                    linewidth = len(line)
                    first_line = False
        if name is not None:
            entries.append((name, length, offset, linebases, linewidth))
    fai = fa_path + ".fai"
    with open(fai, "w") as out:
        for e in entries:
            out.write("\t".join(str(x) for x in e) + "\n")
    return fai


class RefGenome:
    """Random access FASTA queries via .fai."""

    def __init__(self, fasta: str | None = None):
        self._fa = None
        self._fai: dict[str, tuple[int, int, int, int]] = {}
        self._order: list[str] = []
        if fasta is not None:
            if not self.load_index(fasta):
                raise IOError(f"RefGenome: cannot open {fasta}")

    def load_index(self, fasta: str) -> bool:
        """Open ``fasta`` and its ``.fai`` (built when absent); False
        when the FASTA does not exist."""
        if not os.path.exists(fasta):
            return False
        fai = fasta + ".fai"
        if not os.path.exists(fai):
            build_faidx(fasta)
        self._fa = open(fasta, "rb")
        self._fai = {}
        self._order = []
        with open(fai) as fh:
            for line in fh:
                name, ln, off, lb, lw = line.split("\t")[:5]
                self._fai[name] = (int(ln), int(off), int(lb), int(lw))
                self._order.append(name)
        return True

    def is_empty(self) -> bool:
        return self._fa is None

    def names(self) -> list[str]:
        return list(self._order)

    def get_sequence_length(self, name: str) -> int:
        return self._fai[name][0] if name in self._fai else -1

    def query_region(self, chrname: str, p1: int, p2: int) -> str:
        """The 0-based inclusive [p1, p2] substring; raises on an unknown
        name or a range outside the sequence."""
        if self._fa is None:
            raise RuntimeError("RefGenome::QueryRegion - no index loaded")
        if chrname not in self._fai:
            raise ValueError(
                f"RefGenome::QueryRegion - chr {chrname} not in index")
        ln, off, lb, lw = self._fai[chrname]
        if p1 < 0 or p2 < p1 or p2 >= ln:
            raise ValueError(
                f"RefGenome::QueryRegion - invalid range {p1}-{p2} "
                f"for {chrname} (len {ln})")
        start_byte = off + (p1 // lb) * lw + (p1 % lb)
        end_byte = off + (p2 // lb) * lw + (p2 % lb) + 1
        self._fa.seek(start_byte)
        raw = self._fa.read(end_byte - start_byte)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode()

    LoadIndex = load_index
    QueryRegion = query_region
