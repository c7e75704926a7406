"""ctypes loader for the host C++ runtime (counterpart of seqlib_tpu/native.py).

Compiles the repository's ``native/sais.cpp`` (SA-IS suffix array) and
``native/bamenc.cpp`` (columnar hits -> BAM/SAM records) unchanged with
g++ into ``seqlib_tpu_torch/build/`` at first use.  Both sources are
self-contained C++17; the build writes to a temporary name and renames
it into place, so concurrent first uses (test workers) never load a
half-written library.
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
_SOURCES = ("sais.cpp", "bamenc.cpp")
_SO_NAME = "libseqlib_torch_host.so"

_lib = None


def _build_so() -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, _SO_NAME)
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    newest = max(os.path.getmtime(s) for s in srcs)
    if os.path.exists(so) and os.path.getmtime(so) >= newest:
        return so
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", *srcs,
           "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=600)
    except subprocess.CalledProcessError as e:
        os.unlink(tmp)
        raise RuntimeError("seqlib_tpu_torch.native: g++ failed:\n"
                           + e.stderr.decode(errors="replace")) from e
    os.replace(tmp, so)
    return so


def get_lib():
    """The loaded host library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build_so())
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


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


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
