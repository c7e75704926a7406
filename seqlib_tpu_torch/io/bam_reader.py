"""BamReader: pull reader over BAM, CRAM and SAM files and stdin, with
BAI and .crai region queries (counterpart of
seqlib_tpu/io/bam_reader.py).

``next()`` returns a BamRecord or ``None`` at the end; ``set_region`` /
``set_regions`` (GenomicRegion, 1-based inclusive) seek through the
file's ``.bai`` and advance from one region to the next.  A region keeps
the records with ``position_end() > pos1 - 1`` and ``pos < pos2`` and
stops at the first record at or past ``pos2``, so it answers rightly on
a coordinate-sorted file only.  A CRAM file reads through
``CramReader``, its regions through ``<path>.crai``; a reference-based
CRAM needs ``set_cram_reference`` unless it embeds its reference.
"""

from __future__ import annotations

import io
import os
import sys

from ..core.header import BamHeader
from ..core.record import BamRecord
from ..core.region import GenomicRegion
from .bai import BaiIndex
from .bam import read_bam_header, read_record
from .bgzf import BgzfReader, is_bgzf
from .sam import parse_sam_line


class BamReader:
    def __init__(self, path: str | None = None):
        self._path = None
        self._mode = None  # "bam" | "sam" | "cram"
        self._bgzf: BgzfReader | None = None
        self._sam_fh = None
        self._cram = None
        self._cram_reference = None
        self._header = BamHeader()
        self._index: BaiIndex | None = None
        self._regions: list[GenomicRegion] = []
        self._region_idx = 0
        self._chunks: list[tuple[int, int]] = []
        self._chunk_idx = 0
        self._in_region = False
        if path is not None:
            if not self.open(path):
                raise IOError(f"BamReader: cannot open {path}")

    # -- open/close -------------------------------------------------------------

    def open(self, path: str) -> bool:
        self._path = path
        try:
            if path == "-":
                self._open_stream(sys.stdin.buffer)
                return True
            if not os.path.exists(path):
                return False
            with open(path, "rb") as _fh:
                magic6 = _fh.read(6)
            if magic6 == b"CRAM\x03\x00":
                from .cram import CramReader
                self._mode = "cram"
                self._cram = CramReader(path, reference=self._cram_reference)
                self._header = self._cram.header
            elif is_bgzf(path):
                self._mode = "bam"
                self._bgzf = BgzfReader(path)
                self._header = read_bam_header(self._bgzf)
                bai = path + ".bai"
                alt = os.path.splitext(path)[0] + ".bai"
                if os.path.exists(bai):
                    self._index = BaiIndex.load(bai)
                elif os.path.exists(alt):
                    self._index = BaiIndex.load(alt)
            else:
                self._mode = "sam"
                self._sam_fh = open(path, "r")
                self._read_sam_header()
            return True
        except (OSError, ValueError):
            return False

    def _open_stream(self, stream) -> None:
        head = stream.peek(4)[:4] if hasattr(stream, "peek") else b""
        if head[:2] == b"\x1f\x8b":
            self._mode = "bam"
            self._bgzf = BgzfReader(stream)
            self._header = read_bam_header(self._bgzf)
        else:
            self._mode = "sam"
            self._sam_fh = io.TextIOWrapper(stream)
            self._read_sam_header()

    def _read_sam_header(self) -> None:
        """The leading '@' lines become the header; the first record line
        waits in ``_sam_pending``."""
        header_lines = []
        self._sam_pending = None
        for line in self._sam_fh:
            if line.startswith("@"):
                header_lines.append(line)
            else:
                self._sam_pending = line
                break
        self._header = BamHeader("".join(header_lines))

    def is_open(self) -> bool:
        return self._mode is not None

    def header(self) -> BamHeader:
        return self._header

    def close(self) -> None:
        if self._cram is not None:
            self._cram.close()
            self._cram = None
        if self._bgzf:
            self._bgzf.close()
        if self._sam_fh:
            self._sam_fh.close()
        self._mode = None
        self._bgzf = None
        self._sam_fh = None

    def set_cram_reference(self, fasta) -> None:
        """Reference for decoding a reference-based (RR=1) CRAM without
        an embedded reference: a FASTA path, a dict name -> sequence, or
        a RefGenome.  Before or after ``open``."""
        self._cram_reference = fasta
        if self._cram is not None:
            self._cram.set_reference(fasta)

    def reset(self) -> None:
        """Close and reopen, dropping the regions."""
        path = self._path
        self.close()
        self._regions = []
        self._region_idx = 0
        self._in_region = False
        self.open(path)

    # -- regions -------------------------------------------------------------

    def set_region(self, gr: GenomicRegion) -> bool:
        return self.set_regions([gr])

    def set_regions(self, grc) -> bool:
        if self._mode == "cram":
            return self._cram.set_regions(list(grc))
        if self._mode != "bam" or self._index is None:
            return False
        self._regions = list(grc)
        self._region_idx = 0
        return self._arm_region()

    def _arm_region(self) -> bool:
        while self._region_idx < len(self._regions):
            gr = self._regions[self._region_idx]
            beg = max(gr.pos1 - 1, 0)
            self._chunks = self._index.chunks_for_region(gr.chr, beg, gr.pos2)
            self._chunk_idx = 0
            self._in_region = True
            if self._chunks:
                self._bgzf.seek_virtual(self._chunks[0][0])
                return True
            self._region_idx += 1
        self._in_region = True  # armed but exhausted -> Next() returns None
        self._chunks = []
        return True

    # -- iteration -------------------------------------------------------------

    def next(self) -> BamRecord | None:
        if self._mode == "sam":
            return self._next_sam()
        if self._mode == "cram":
            return self._cram.next()
        if self._mode != "bam":
            return None
        if self._in_region:
            return self._next_region()
        return read_record(self._bgzf)

    def _next_region(self) -> BamRecord | None:
        while self._region_idx < len(self._regions):
            gr = self._regions[self._region_idx]
            beg, end = max(gr.pos1 - 1, 0), gr.pos2
            while self._chunk_idx < len(self._chunks):
                cb, ce = self._chunks[self._chunk_idx]
                if self._bgzf.tell_virtual() >= ce:
                    self._chunk_idx += 1
                    if self._chunk_idx < len(self._chunks):
                        self._bgzf.seek_virtual(
                            self._chunks[self._chunk_idx][0])
                    continue
                rec = read_record(self._bgzf)
                if rec is None:
                    self._chunk_idx = len(self._chunks)
                    break
                if rec.tid != gr.chr or rec.pos >= end:
                    # sorted file: past the region end
                    self._chunk_idx = len(self._chunks)
                    break
                rec_end = rec.position_end()
                if rec_end > beg and rec.pos < end:
                    return rec
            # on to the next region
            self._region_idx += 1
            if self._region_idx < len(self._regions):
                self._arm_region()
        return None

    def _next_sam(self) -> BamRecord | None:
        if getattr(self, "_sam_pending", None) is not None:
            line, self._sam_pending = self._sam_pending, None
            return parse_sam_line(line, self._header)
        if self._sam_fh is None:
            return None
        line = self._sam_fh.readline()
        if not line:
            return None
        return parse_sam_line(line, self._header)

    # -- iteration sugar -----------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        rec = self.next()
        if rec is None:
            raise StopIteration
        return rec

    # reference-style aliases
    Open = open
    Close = close
    Next = next
    Reset = reset
    Header = header
    SetRegion = set_region
    SetRegions = set_regions
