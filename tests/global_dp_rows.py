"""Inputs of the global DP and its traceback for the tests that hold the
kernel (``tests/test_torch_gpu.py``) and the plain route
(``tests/test_torch_sw.py``): windows as the aligner pads them, and the
edge rows the plain route must keep; and ``runs_of_codes``, the decoder
that turns the JAX package's packed step codes into the port's CIGAR
runs, for the tests that hold the port to the JAX package."""

import numpy as np


def global_dp_rows(M: int, Lq: int, Lt: int, seed: int = 0,
                   band: int = 208):
    """(q, ql, t, tl) numpy inputs of the global DP and traceback, shaped
    as the aligner pads them (uint8 nt4 codes, 4 past the lengths, int32
    lengths): query windows with up to six edits (substitutions, indels
    of 1-8 bases) copied into the target window, a tenth of the rows
    random windows, and then the edge rows the plain route must keep:
    ql = 0, tl = 0, both 0, all-N windows, an end cell outside the band
    (tl - ql > band), ql = Lq, tl = Lt."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (M, Lq)).astype(np.uint8)
    t = np.full((M, Lt), 4, np.uint8)
    ql = rng.integers(0, Lq + 1, M).astype(np.int32)
    tl = np.zeros(M, np.int32)
    for m in range(M):
        s = list(q[m, :ql[m]])
        for _ in range(int(rng.integers(0, 7))):
            if not s:
                break
            p, op, n = (int(rng.integers(0, len(s))),
                        int(rng.integers(0, 3)), int(rng.integers(1, 9)))
            if op == 0:
                s[p] = (s[p] + 1) % 4
            elif op == 1:
                del s[p:p + n]
            else:
                s[p:p] = list(rng.integers(0, 4, n))
        s = s[:Lt]
        t[m, :len(s)] = s
        tl[m] = len(s)
    rand = rng.random(M) < 0.1
    tl[rand] = rng.integers(0, Lt + 1, int(rand.sum()))
    t[rand] = rng.integers(0, 5, (int(rand.sum()), Lt))
    edges = [(0, None), (None, 0), (0, 0), ("N", "N"),
             (max(Lq // 8, 1), None), (Lq, Lt), (1, 1)]
    for m, (a, b) in zip(range(M), edges):
        if a == "N":
            ql[m], tl[m] = Lq, min(Lq, Lt)
            q[m] = 4
            t[m] = 4
            continue
        if a is not None:
            ql[m] = a
        if b is not None:
            tl[m] = b
        if (a, b) == (max(Lq // 8, 1), None):
            tl[m] = min(Lt, ql[m] + band + 1 + int(rng.integers(0, 16)))
    q[np.arange(Lq)[None, :] >= ql[:, None]] = 4
    t[np.arange(Lt)[None, :] >= tl[:, None]] = 4
    return q, ql, t, tl


def runs_of_codes(packed, n_rows=None):
    """The JAX package's traceback output, uint8 [M, T/4] step codes in
    walk order (4 a byte at bits 0/2/4/6, 3 = no op), -> the port's
    (run_off int64 [M + 1], runs int32) over its first ``n_rows`` rows
    (all by default; the others get no runs): the codes unpacked and
    reversed into forward order, the no-op steps dropped, each stretch of
    one op a run, its word op << 30 | length."""
    p = np.asarray(packed).astype(np.uint8)
    M = p.shape[0]
    n_rows = M if n_rows is None else n_rows
    ops = np.stack([(p >> s) & 3 for s in (0, 2, 4, 6)], axis=2)
    fwd = ops.reshape(M, 4 * p.shape[1])[:n_rows, ::-1]
    rows, cols = np.nonzero(fwd < 3)
    vals = fwd[rows, cols].astype(np.int64)
    brk = np.ones(vals.size, bool)
    brk[1:] = (rows[1:] != rows[:-1]) | (vals[1:] != vals[:-1])
    starts = np.flatnonzero(brk)
    lens = np.diff(np.append(starts, vals.size))
    run_off = np.zeros(M + 1, np.int64)
    run_off[1:] = np.cumsum(np.bincount(rows[starts], minlength=M))
    words = ((vals[starts] << 30) | lens).astype(np.uint32)
    return run_off, words.view(np.int32)
