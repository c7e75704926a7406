"""BamWriter: BAM and SAM writer with a BAI index, built inline or after
close (counterpart of seqlib_tpu/io/bam_writer.py).

The format comes from the constant given (``SAM`` = 3, ``BAM`` = 4,
``CRAM`` = 6, the reference API's numbers) or from the path's extension.
CRAM output raises NotImplementedError.  An index answers rightly only
over a coordinate-sorted file: sort the records (``sort_by_position``)
before ``enable_indexing``.
"""

from __future__ import annotations

import sys

from ..core.header import BamHeader
from ..core.record import BamRecord
from .bai import BaiIndex
from .bam import encode_record, read_bam_header, read_record, write_bam_header
from .bgzf import BgzfReader, BgzfWriter

SAM = 3
BAM = 4
CRAM = 6


class BamWriter:
    def __init__(self, fmt: int | None = None):
        self._fmt = fmt
        self._path: str | None = None
        self._bgzf: BgzfWriter | None = None
        self._sam_fh = None
        self._header: BamHeader | None = None
        self._header_written = False
        self._index = None
        self._last_key = None

    # -- open ----------------------------------------------------------------

    def open(self, path: str) -> bool:
        self._path = path
        fmt = self._fmt
        if fmt is None:
            if path.endswith(".sam") or path == "-":
                fmt = SAM
            elif path.endswith(".cram"):
                fmt = CRAM
            else:
                fmt = BAM
            self._fmt = fmt
        try:
            if fmt == SAM:
                self._sam_fh = (sys.stdout if path == "-"
                                else open(path, "w"))
            elif fmt == CRAM:
                raise NotImplementedError(
                    "BamWriter: seqlib_tpu_torch does not write CRAM yet "
                    "(ROADMAP.md section 1, item 5)")
            else:
                target = sys.stdout.buffer if path == "-" else path
                self._bgzf = BgzfWriter(target)
            return True
        except OSError:
            return False

    def is_open(self) -> bool:
        return self._bgzf is not None or self._sam_fh is not None

    # -- header --------------------------------------------------------------

    def set_header(self, hdr: BamHeader) -> None:
        self._header = hdr

    def write_header(self) -> bool:
        if self._header is None:
            raise RuntimeError(
                "BamWriter::WriteHeader - no header supplied")
        if self._fmt == SAM:
            self._sam_fh.write(self._header.as_string())
            if not self._header.as_string().endswith("\n"):
                self._sam_fh.write("\n")
        else:
            write_bam_header(self._bgzf, self._header)
        self._header_written = True
        return True

    # -- records -------------------------------------------------------------

    def write_record(self, rec: BamRecord) -> bool:
        if not self._header_written:
            self.write_header()
        if self._fmt == SAM:
            self._sam_fh.write(rec.to_sam(self._header) + "\n")
            return True
        voff_beg = self._bgzf.tell_virtual()
        self._bgzf.write(encode_record(rec))
        voff_end = self._bgzf.tell_virtual()
        if self._index is not None:
            end = rec.pos + max(rec.cigar.num_reference_consumed(), 1)
            self._index.add_record(rec.tid, rec.pos, end, voff_beg, voff_end,
                                   rec.mapped_flag())
        return True

    def write_records_bytes(self, payload: bytes) -> bool:
        """Write serialised BAM records (the payload of
        ``align_batch_bam`` / ``align_stream_bam``) straight through
        ``BgzfWriter.write_bulk``.  BAM only, and not with
        ``enable_indexing``: the records bypass the per-record
        virtual-offset bookkeeping."""
        if self._fmt != BAM:
            raise ValueError("write_records_bytes requires BAM output")
        if self._index is not None:
            raise ValueError("write_records_bytes is incompatible "
                             "with enable_indexing")
        if not self._header_written:
            self.write_header()
        self._bgzf.write_bulk(payload)
        return True

    def enable_indexing(self) -> None:
        """Collect the BAI while records are written; ``close()`` then
        writes ``<path>.bai``."""
        if self._header is None:
            raise RuntimeError("enable_indexing requires a header first")
        self._index = BaiIndex(self._header.num_sequences())

    def build_index(self) -> bool:
        """Write ``<path>.bai`` for the closed BAM output: the inline
        index if one was collected, else one built by reading the file
        back."""
        if self._fmt != BAM or self._path in (None, "-"):
            return False
        if self._index is not None:
            self._index.save(self._path + ".bai")
            return True
        r = BgzfReader(self._path)
        hdr = read_bam_header(r)
        idx = BaiIndex(hdr.num_sequences())
        while True:
            voff = r.tell_virtual()
            rec = read_record(r)
            if rec is None:
                break
            end = rec.pos + max(rec.cigar.num_reference_consumed(), 1)
            idx.add_record(rec.tid, rec.pos, end, voff, r.tell_virtual(),
                           rec.mapped_flag())
        r.close()
        idx.save(self._path + ".bai")
        return True

    def close(self) -> bool:
        if self._fmt == SAM:
            if self._sam_fh not in (None, sys.stdout):
                self._sam_fh.close()
            self._sam_fh = None
        elif self._bgzf is not None:
            self._bgzf.close()
            self._bgzf = None
            if self._index is not None and self._path not in (None, "-"):
                self._index.save(self._path + ".bai")
        return True

    # reference-style aliases
    Open = open
    Close = close
    SetHeader = set_header
    WriteHeader = write_header
    WriteRecord = write_record
    BuildIndex = build_index
