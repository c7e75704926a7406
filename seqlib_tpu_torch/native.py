"""ctypes loader for the host C++ runtime (counterpart of seqlib_tpu/native.py).

Compiles the repository's ``native/`` sources unchanged with g++ into
``seqlib_tpu_torch/build/`` at first use, as two libraries:

* ``libseqlib_torch_host.so``: ``sais.cpp`` (SA-IS suffix array) and
  ``bamenc.cpp`` (columnar hits -> BAM/SAM records), self-contained
  C++17;
* ``libseqlib_torch_bamio.so``: ``bamio.cpp`` (BGZF inflate and
  deflate over 64 KiB members on threads, the columnar BAM record scan),
  linked with zlib, so a host without zlib's headers loses BAM file I/O
  and keeps the aligner.

Each build writes to a temporary name and renames it into place, so
concurrent first uses (test workers) never load a half-written library.
A library that cannot be built raises with the compiler's message; no
entry point falls back to Python.  The BAM I/O wrappers return ``None``
for data they cannot parse (the readers raise ``ValueError`` on it).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_PKG)
_SRC_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_PKG, "build")
_HOST = (("sais.cpp", "bamenc.cpp"), "libseqlib_torch_host.so", ())
_BAMIO = (("bamio.cpp",), "libseqlib_torch_bamio.so", ("-lz", "-pthread"))

_lib = None
_bamio = None


def _build_so(sources, so_name: str, libs) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, so_name)
    srcs = [os.path.join(_SRC_DIR, s) for s in sources]
    newest = max(os.path.getmtime(s) for s in srcs)
    if os.path.exists(so) and os.path.getmtime(so) >= newest:
        return so
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", *srcs,
           "-o", tmp, *libs]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=600)
    except subprocess.CalledProcessError as e:
        os.unlink(tmp)
        err = e.stderr.decode(errors="replace")
        why = ("zlib's headers (zlib.h) are missing on this host, so BAM "
               "file I/O cannot be built\n" if "zlib.h" in err else "")
        raise RuntimeError(f"seqlib_tpu_torch.native: g++ failed to build "
                           f"{so_name}:\n{why}{err}") from e
    os.replace(tmp, so)
    return so


def get_lib():
    """The loaded host library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build_so(*_HOST))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.sais_u8.restype = ctypes.c_int
        lib.sais_u8.argtypes = [u8p, ctypes.c_int64, i64p]
        lib.bam_encode_hits.restype = ctypes.c_int64
        lib.bam_encode_hits.argtypes = (
            [ctypes.c_int64]                     # n_hits
            + [i32p] * 3                         # read_idx, rid, pos
            + [u8p] * 2                          # is_rev, is_sec
            + [i32p] * 8                         # score..clip3
            + [i64p, i32p, u8p, i32p, i32p]      # cigar runs
            + [ctypes.c_int32, u8p, i64p, u8p, i64p]   # reads
            + [ctypes.c_int32, u8p, i64p]        # ref names
            + [ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
               ctypes.c_double, ctypes.c_int32, ctypes.c_int32]
            + [u8p, ctypes.c_int64, i32p])       # out
        _lib = lib
    return _lib


def get_bamio_lib():
    """The loaded BAM I/O library (built on first call)."""
    global _bamio
    if _bamio is None:
        lib = ctypes.CDLL(_build_so(*_BAMIO))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i64 = ctypes.c_int64
        lib.bgzf_inflate_all.restype = i64
        lib.bgzf_inflate_all.argtypes = [u8p, i64, u8p, i64]
        lib.bgzf_total_isize.restype = i64
        lib.bgzf_total_isize.argtypes = [u8p, i64]
        lib.bgzf_inflate_all_mt.restype = i64
        lib.bgzf_inflate_all_mt.argtypes = [u8p, i64, u8p, i64,
                                            ctypes.c_int32]
        lib.bgzf_deflate_all_mt.restype = i64
        lib.bgzf_deflate_all_mt.argtypes = [u8p, i64, ctypes.c_int32,
                                            ctypes.c_int32, u8p, i64]
        lib.bam_scan_records.restype = i64
        lib.bam_scan_records.argtypes = (
            [u8p, i64, i64, i64p] + [i32p] * 8
            + [i64p, i32p, i64p, i32p, i64p, i64p, i64p, i32p, i64p])
        lib.bam_ref_spans.restype = None
        lib.bam_ref_spans.argtypes = [u8p, i64, i64p, i32p, i32p]
        lib.bam_unpack_seqs.restype = None
        lib.bam_unpack_seqs.argtypes = [u8p, i64, i64p, i32p, u8p, i64p]
        _bamio = lib
    return _bamio


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _threads() -> int:
    return os.cpu_count() or 1


# ---------------------------------------------------------------------------
# BAM I/O (native/bamio.cpp)
# ---------------------------------------------------------------------------

def bgzf_inflate_all(data):
    """A whole BGZF byte stream (complete members) -> its inflated bytes
    (uint8 array), the members on threads; ``None`` when the stream is
    malformed.  The output size comes from a pre-scan of the members'
    ISIZE fields."""
    lib = get_bamio_lib()
    src = np.frombuffer(data, dtype=np.uint8)
    u8 = ctypes.c_uint8
    cap = int(lib.bgzf_total_isize(_ptr(src, u8), src.size))
    if cap < 0:
        return None
    out = np.empty(max(cap, 1), dtype=np.uint8)
    n = lib.bgzf_inflate_all_mt(_ptr(src, u8), src.size, _ptr(out, u8),
                                out.size, ctypes.c_int32(_threads()))
    if n < 0:
        return None
    return out[:n]


def bgzf_deflate_all(data: bytes, level: int = 6):
    """Bytes -> concatenated BGZF members of 65,280 input bytes each
    (the Python writer's blocks; no EOF member), deflated on threads;
    ``None`` for empty input or when a block cannot be deflated."""
    lib = get_bamio_lib()
    if not data:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    n_blocks = (src.size + 65279) // 65280
    out = np.empty(n_blocks * 65536, dtype=np.uint8)
    n = lib.bgzf_deflate_all_mt(
        _ptr(src, ctypes.c_uint8), src.size, ctypes.c_int32(level),
        ctypes.c_int32(_threads()), _ptr(out, ctypes.c_uint8), out.size)
    if n < 0:
        return None
    return out[:n].tobytes()


_SCAN_I64 = ("offsets", "qname_off", "cigar_off", "seq_off", "qual_off",
             "aux_off")
_SCAN_ORDER = ("offsets", "tid", "pos", "mapq", "flag", "lseq", "mtid",
               "mpos", "isize", "qname_off", "qname_len", "cigar_off",
               "n_cigar", "seq_off", "qual_off", "aux_off", "aux_len")


def bam_scan_records(buf: np.ndarray, cap: int):
    """Columnar scan of inflated BAM records (after the header): returns
    (n, columns, consumed), n <= cap complete records and the bytes they
    take; the columns hold core fields and offsets into ``buf``."""
    lib = get_bamio_lib()
    cols = {k: np.empty(cap, np.int64 if k in _SCAN_I64 else np.int32)
            for k in _SCAN_ORDER}
    consumed = np.zeros(1, np.int64)
    n = lib.bam_scan_records(
        _ptr(buf, ctypes.c_uint8), buf.size, cap,
        *(_ptr(cols[k], ctypes.c_int64 if k in _SCAN_I64
               else ctypes.c_int32) for k in _SCAN_ORDER),
        _ptr(consumed, ctypes.c_int64))
    return int(n), {k: v[:n] for k, v in cols.items()}, int(consumed[0])


def bam_ref_spans(buf: np.ndarray, cigar_off: np.ndarray,
                  n_cigar: np.ndarray) -> np.ndarray:
    """Reference span per record (M/D/N/=/X lengths of its CIGAR)."""
    lib = get_bamio_lib()
    co = np.ascontiguousarray(cigar_off, np.int64)
    nc = np.ascontiguousarray(n_cigar, np.int32)
    out = np.empty(co.size, np.int32)
    lib.bam_ref_spans(_ptr(buf, ctypes.c_uint8), co.size,
                      _ptr(co, ctypes.c_int64), _ptr(nc, ctypes.c_int32),
                      _ptr(out, ctypes.c_int32))
    return out


def bam_unpack_seqs(buf: np.ndarray, seq_off: np.ndarray,
                    lseq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """ASCII base blob of the records' sequences + each one's start
    (length n + 1)."""
    lib = get_bamio_lib()
    so = np.ascontiguousarray(seq_off, np.int64)
    ls = np.ascontiguousarray(lseq, np.int32)
    dst_off = np.zeros(ls.size + 1, np.int64)
    np.cumsum(ls, out=dst_off[1:])
    dst = np.empty(int(dst_off[-1]), np.uint8)
    lib.bam_unpack_seqs(_ptr(buf, ctypes.c_uint8), ls.size,
                        _ptr(so, ctypes.c_int64), _ptr(ls, ctypes.c_int32),
                        _ptr(dst, ctypes.c_uint8),
                        _ptr(dst_off, ctypes.c_int64))
    return dst, dst_off


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of ``text`` (uint8 codes >= 1) with an implicit
    terminal sentinel: length len(text)+1, SA[0] == len(text)."""
    t = np.asarray(text, dtype=np.uint8)
    if t.size and t.min() < 1:
        raise ValueError("suffix_array: symbols must be >= 1")
    padded = np.concatenate([t, np.zeros(1, dtype=np.uint8)])
    sa = np.empty(padded.size, dtype=np.int64)
    rc = get_lib().sais_u8(_ptr(padded, ctypes.c_uint8),
                           ctypes.c_int64(padded.size),
                           _ptr(sa, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"sais_u8 failed (rc={rc})")
    return sa


def bam_encode_hits(cols: dict, qname_blob: np.ndarray,
                    qname_off: np.ndarray, seq_blob: np.ndarray,
                    seq_off: np.ndarray, ref_blob: np.ndarray,
                    ref_off: np.ndarray, hardclip: bool,
                    keep_sec_frac: float, max_secondary: int,
                    xa_drop_ratio: float, max_xa_hits: int,
                    mode: int = 0):
    """Columnar hits -> serialized BAM records (mode 0) or SAM text
    (mode 1).  Returns (payload bytes, per-read record counts)."""
    lib = get_lib()
    n_hits = int(cols["read_idx"].size)
    n_reads = int(qname_off.size - 1)
    n_refs = int(ref_off.size - 1)
    counts = np.zeros(max(n_reads, 1), np.int32)
    L = int(seq_off[-1] - (seq_off[0] if seq_off.size else 0))
    cap = 1024 + n_hits * 160 + 2 * L \
        + int(qname_off[-1]) + 8 * int(cols["run_lens"].size)
    u8, i32, i64 = ctypes.c_uint8, ctypes.c_int32, ctypes.c_int64
    keep = []                       # keep converted arrays alive

    def p(a, dt, ct):
        a = np.ascontiguousarray(a, dt)
        keep.append(a)
        return _ptr(a, ct)

    def p8(a):
        return p(a, np.uint8, u8)

    def p32(a):
        return p(a, np.int32, i32)

    def p64(a):
        return p(a, np.int64, i64)

    for _ in range(8):
        out = np.empty(cap, np.uint8)
        n = lib.bam_encode_hits(
            ctypes.c_int64(n_hits),
            p32(cols["read_idx"]), p32(cols["rid"]), p32(cols["pos"]),
            p8(cols["is_rev"]), p8(cols["is_sec"]),
            p32(cols["score"]), p32(cols["mapq"]), p32(cols["nm"]),
            p32(cols["n_regs"]), p32(cols["slot"]), p32(cols["sec"]),
            p32(cols["clip5"]), p32(cols["clip3"]),
            p64(cols["cig_off"]), p32(cols["cig_n"]),
            p8(cols["run_ops"]), p32(cols["run_lens"]),
            p32(cols["match_len"]),
            ctypes.c_int32(n_reads), p8(qname_blob), p64(qname_off),
            p8(seq_blob), p64(seq_off),
            ctypes.c_int32(n_refs), p8(ref_blob), p64(ref_off),
            ctypes.c_int32(1 if hardclip else 0),
            ctypes.c_double(keep_sec_frac),
            ctypes.c_int32(max_secondary),
            ctypes.c_double(xa_drop_ratio),
            ctypes.c_int32(max_xa_hits), ctypes.c_int32(mode),
            _ptr(out, u8), ctypes.c_int64(cap), _ptr(counts, i32))
        if n == -1:
            cap *= 4
            continue
        if n < 0:
            raise RuntimeError(
                f"bam_encode_hits: malformed columnar input (rc={n})")
        return out[:n].tobytes(), counts[:n_reads]
    raise RuntimeError("bam_encode_hits: output buffer kept overflowing")
