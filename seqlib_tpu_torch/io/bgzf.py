"""BGZF (blocked gzip) codec (counterpart of seqlib_tpu/io/bgzf.py).

A BGZF file is a series of gzip members of at most 64 KiB inflated,
each carrying its compressed size in a BC extra field, ending with a
fixed 28-byte EOF member.  Virtual offsets are
``(compressed_block_offset << 16) | within_block_offset``.  The Python
route writes one member at a time through ``zlib``; ``write_bulk``
deflates a large buffer's members on threads in ``native/bamio.cpp``,
with the same member layout.
"""

from __future__ import annotations

import struct
import zlib

from .. import native

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

MAX_BLOCK = 0x10000  # 64 KiB of uncompressed data per block


class BgzfReader:
    """Random-access BGZF reader with virtual-offset seek."""

    def __init__(self, path_or_fileobj):
        if hasattr(path_or_fileobj, "read"):
            self._fh = path_or_fileobj
            self._owns = False
        else:
            self._fh = open(path_or_fileobj, "rb")
            self._owns = True
        self._block_start = 0     # compressed offset of current block
        self._buf = b""           # current decompressed block
        self._within = 0          # offset within current block
        self._next_block = 0      # compressed offset of next block
        self._load_block(0)

    # -- block machinery ----------------------------------------------------

    def _load_block(self, coffset: int) -> bool:
        self._fh.seek(coffset)
        hdr = self._fh.read(18)
        if len(hdr) == 0:
            self._block_start = coffset
            self._buf = b""
            self._within = 0
            self._next_block = coffset
            return False
        if len(hdr) < 18 or hdr[0] != 0x1F or hdr[1] != 0x8B:
            raise ValueError("BGZF: bad gzip magic")
        xlen = struct.unpack_from("<H", hdr, 10)[0]
        extra = hdr[12:18]
        # find BSIZE in the extra fields (usually the first one)
        bsize = None
        extra_full = extra + self._fh.read(max(0, xlen - 6))
        i = 0
        while i + 4 <= len(extra_full):
            si1, si2, slen = extra_full[i], extra_full[i + 1], \
                struct.unpack_from("<H", extra_full, i + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra_full, i + 4)[0] + 1
                break
            i += 4 + slen
        if bsize is None:
            raise ValueError("BGZF: missing BC extra field")
        cdata_len = bsize - 12 - xlen - 8
        if cdata_len < 0:
            raise ValueError("BGZF: invalid BSIZE")
        cdata = self._fh.read(cdata_len)
        if len(cdata) < cdata_len:
            raise EOFError("BGZF: truncated block payload")
        trailer = self._fh.read(8)  # crc32 + isize
        if len(trailer) < 8:
            raise EOFError("BGZF: truncated block trailer")
        try:
            d = zlib.decompressobj(-15)
            buf = d.decompress(cdata, 65536)
            if d.unconsumed_tail:
                raise ValueError("BGZF: block inflates past 64 KiB")
        except zlib.error as e:
            raise ValueError(f"BGZF: corrupt deflate payload ({e})")
        crc, isize = struct.unpack("<II", trailer)
        if isize != len(buf) or zlib.crc32(buf) != crc:
            raise ValueError("BGZF: block CRC/ISIZE mismatch")
        self._buf = buf
        self._block_start = coffset
        self._within = 0
        self._next_block = coffset + bsize
        return True

    def _advance(self) -> bool:
        nb = self._next_block
        ok = self._load_block(nb)
        return ok and len(self._buf) > 0

    # -- public API ---------------------------------------------------------

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            avail = len(self._buf) - self._within
            if avail == 0:
                if not self._advance():
                    break
                continue
            take = min(avail, n)
            out += self._buf[self._within:self._within + take]
            self._within += take
            n -= take
        return bytes(out)

    def tell_virtual(self) -> int:
        if self._within == len(self._buf) and self._buf:
            # normalize to start of next block
            return self._next_block << 16
        return (self._block_start << 16) | self._within

    def seek_virtual(self, voffset: int) -> None:
        coffset = voffset >> 16
        within = voffset & 0xFFFF
        if coffset != self._block_start or not self._buf:
            self._load_block(coffset)
        self._within = within

    def eof(self) -> bool:
        if self._within < len(self._buf):
            return False
        # peek next block
        pos = self._fh.tell()
        self._fh.seek(self._next_block)
        nxt = self._fh.read(1)
        self._fh.seek(pos)
        if not nxt:
            return True
        # block exists; check if it decompresses to something
        cur = (self._block_start, self._within)
        if not self._advance():
            return True
        if len(self._buf) == 0:
            return True
        # rewind
        self._load_block(cur[0])
        self._within = cur[1]
        return False

    def close(self) -> None:
        if self._owns:
            self._fh.close()


class BgzfWriter:
    """BGZF writer; compresses 64 KiB chunks and appends the EOF member."""

    def __init__(self, path_or_fileobj, level: int = 6):
        if hasattr(path_or_fileobj, "write"):
            self._fh = path_or_fileobj
            self._owns = False
        else:
            self._fh = open(path_or_fileobj, "wb")
            self._owns = True
        self._level = level
        self._pending = bytearray()
        self._closed = False

    def write(self, data: bytes) -> None:
        self._pending += data
        while len(self._pending) >= MAX_BLOCK - 256:
            chunk = bytes(self._pending[:MAX_BLOCK - 256])
            del self._pending[:MAX_BLOCK - 256]
            self._write_block(chunk)

    def write_bulk(self, data: bytes) -> None:
        """Write a large buffer through the native deflater
        (``native.bgzf_deflate_all``: the Python route's member layout,
        blocks deflated on threads); under four blocks it takes the
        Python route.

        Flushes pending bytes into their own block first, so virtual
        offsets of records written before stay valid."""
        if len(data) < 4 * (MAX_BLOCK - 256):
            self.write(data)
            return
        self.flush_block()
        comp = native.bgzf_deflate_all(bytes(data), self._level)
        if comp is None:
            raise RuntimeError("BGZF: native deflate failed")
        self._fh.write(comp)

    def tell_virtual(self) -> int:
        return (self._fh.tell() << 16) | len(self._pending)

    def flush_block(self) -> None:
        if self._pending:
            self._write_block(bytes(self._pending))
            self._pending.clear()

    def _write_block(self, data: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(data) + co.flush()
        bsize = len(cdata) + 26
        if bsize > MAX_BLOCK:
            # store uncompressed-ish (level 0)
            co = zlib.compressobj(0, zlib.DEFLATED, -15)
            cdata = co.compress(data) + co.flush()
            bsize = len(cdata) + 26
        hdr = struct.pack("<BBBBIBBH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
        hdr += struct.pack("<BBHH", 66, 67, 2, bsize - 1)
        self._fh.write(hdr + cdata
                       + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                                     len(data) & 0xFFFFFFFF))

    def close(self) -> None:
        if self._closed:
            return
        self.flush_block()
        self._fh.write(BGZF_EOF)
        if self._owns:
            self._fh.close()
        else:
            self._fh.flush()
        self._closed = True


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as fh:
        hdr = fh.read(18)
    return (len(hdr) >= 18 and hdr[0] == 0x1F and hdr[1] == 0x8B
            and (hdr[3] & 4) != 0 and hdr[12] == 66 and hdr[13] == 67)
