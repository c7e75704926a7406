"""ThreadPool and a BGZF writer that deflates its blocks on it
(counterpart of seqlib_tpu/io/threadpool.py).  ``zlib`` releases the
GIL, so the pool's threads deflate in parallel."""

from __future__ import annotations

import concurrent.futures as _fut
import struct
import zlib

from .bgzf import BGZF_EOF


class ThreadPool:
    def __init__(self, n: int = 1):
        if n < 1:
            raise ValueError("ThreadPool: n must be >= 1")
        self.n = n
        self._pool = _fut.ThreadPoolExecutor(max_workers=n)

    def is_valid(self) -> bool:
        return self._pool is not None

    def submit(self, fn, *args):
        return self._pool.submit(fn, *args)

    def shutdown(self) -> None:
        if self._pool:
            self._pool.shutdown(wait=True)
            self._pool = None

    IsValid = is_valid


def compress_block(data: bytes, level: int = 6) -> bytes:
    """One BGZF member for ``data`` (level 0 when it would not fit)."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    bsize = len(cdata) + 26
    if bsize > 0x10000:
        co = zlib.compressobj(0, zlib.DEFLATED, -15)
        cdata = co.compress(data) + co.flush()
        bsize = len(cdata) + 26
    hdr = struct.pack("<BBBBIBBH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
    hdr += struct.pack("<BBHH", 66, 67, 2, bsize - 1)
    return hdr + cdata + struct.pack(
        "<II", zlib.crc32(data) & 0xFFFFFFFF, len(data) & 0xFFFFFFFF)


class PooledBgzfWriter:
    """BGZF writer that pipelines block compression over a ThreadPool.

    Drop-in for BgzfWriter when record-level virtual offsets are not
    needed (plain streaming write).
    """

    def __init__(self, path_or_fileobj, pool: ThreadPool, level: int = 6,
                 max_inflight: int = 64):
        if hasattr(path_or_fileobj, "write"):
            self._fh = path_or_fileobj
            self._owns = False
        else:
            self._fh = open(path_or_fileobj, "wb")
            self._owns = True
        self._pool = pool
        self._level = level
        self._pending = bytearray()
        self._inflight: list = []
        self._max_inflight = max_inflight
        self._closed = False

    def write(self, data: bytes) -> None:
        self._pending += data
        while len(self._pending) >= 0xFF00:
            chunk = bytes(self._pending[:0xFF00])
            del self._pending[:0xFF00]
            self._inflight.append(
                self._pool.submit(compress_block, chunk, self._level))
            if len(self._inflight) >= self._max_inflight:
                self._drain(self._max_inflight // 2)

    def _drain(self, keep: int = 0) -> None:
        while len(self._inflight) > keep:
            self._fh.write(self._inflight.pop(0).result())

    def close(self) -> None:
        if self._closed:
            return
        if self._pending:
            self._inflight.append(
                self._pool.submit(compress_block, bytes(self._pending),
                                  self._level))
            self._pending.clear()
        self._drain(0)
        self._fh.write(BGZF_EOF)
        if self._owns:
            self._fh.close()
        else:
            self._fh.flush()
        self._closed = True
