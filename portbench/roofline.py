"""Peaks of the card and the least time a kernel's work needs: frozen
copies of ``chip_smoke.py``'s counting arithmetic and
``seqlib_tpu_torch/bench_sw.py``'s ``roof_ms`` and ``band_cells_needed``,
kept here so that a change to the port cannot move them.

Peaks: one NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet):
3.35 TB/s of HBM, and 67 TFLOP/s of float32 outside the tensor cores,
which is two operations on 128 lanes per SM; Hopper has 64 int32 lanes
per SM, so int32 instructions run at a quarter of that, 16.75 TOP/s.
A card set below 700 W (``nvidia-smi``'s ``power.limit``) runs slower:
the harness prints its limit beside every share."""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# int32 instructions per DP cell, the fewest the card needs (a DPX
# add-max counted as one): F, the substitution score, H before E, H, the
# next E, the row max and its first column (bench_sw.OPS_PER_CELL)
OPS_PER_CELL = 8
# K2: instructions per BWT word a rank pops (7 + 4 x 8) and per FMD
# bi-extension (chip_smoke.K2_OPS_PER_WORD, K2_OPS_PER_EXT)
K2_OPS_PER_WORD = 7 + 4 * 8
K2_OPS_PER_EXT = 32


def roof_ms(nbytes: int, ops: int) -> tuple[float, str]:
    """(max(bytes / HBM rate, int32 ops / int32 rate) in ms, which of the
    two bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def band_cells_needed(q, t, tl, w: int, rows) -> int:
    """Band cells |j - R| <= w (R = 1..rows of the lane, j <= tlen) that
    K1's lanes need; ``rows`` is the DP rows each lane ran, from the
    plain version."""
    Lq, Lt = q.shape[1], t.shape[1]
    R = torch.arange(1, Lq + 1, device=q.device)[None, :]
    tle = torch.clamp(tl.to(torch.int64), max=Lt)[:, None]
    live = torch.clamp(torch.minimum(R + w, tle) - torch.clamp(R - w, min=0)
                       + 1, min=0)
    return int((live * (R <= rows.to(torch.int64)[:, None])).sum())


def k1_bound_ms(q, qlen, t, tl, h0, w: int, rows) -> tuple[float, str]:
    """Least time of one K1 call: its lanes' band cells at OPS_PER_CELL,
    against the bytes of its inputs read once and outputs written once
    (3 int32 inputs and 5 int32 outputs a lane)."""
    M = q.shape[0]
    nbytes = q.numel() + t.numel() + 3 * 4 * M + 5 * 4 * M
    return roof_ms(nbytes, OPS_PER_CELL * band_cells_needed(q, t, tl, w,
                                                            rows))


def k2_bound_ms(index_bytes: int, reads, max_seeds: int, p3_seeds: int,
                wide: bool, exts: int, rank_words: int
                ) -> tuple[float, str]:
    """Least time of one K2 call: the index's checkpoint blocks and the
    reads read once, the seeds written once, against the bi-extensions
    and rank words that these inputs need (the plain machine's
    ``count_work``)."""
    B = reads.shape[0]
    S, P3 = max_seeds, p3_seeds
    il = 8 if wide else 4
    nbytes = index_bytes + reads.numel() + 4 * 4 * B + B \
        + (3 * S + 2) * 4 * B + S * il * B + (3 * P3 + 1) * 4 * B \
        + P3 * il * B
    ops = K2_OPS_PER_EXT * exts + K2_OPS_PER_WORD * rank_words
    return roof_ms(nbytes, ops)


def global_dp_cells(qlen, tlen, band: int) -> int:
    """Cells of the banded global DP that rows of these lengths need:
    rows R = 1..qlen, columns 0..tlen with |j - R| <= band."""
    ql = qlen.to(torch.int64).cpu()
    tl = tlen.to(torch.int64).cpu()
    if ql.numel() == 0:
        return 0
    R = torch.arange(1, int(ql.max()) + 1)[None, :]
    live = torch.clamp(torch.minimum(R + band, tl[:, None])
                       - torch.clamp(R - band, min=0) + 1, min=0)
    return int((live * (R <= ql[:, None])).sum())


def global_dp_bound_ms(q, t, qlen, tlen, band: int) -> tuple[float, str]:
    """Least time of one global DP + traceback call: OPS_PER_CELL int32
    instructions and one direction byte a cell, the query and target
    windows read once, score, NM and the packed walk written once."""
    M, Lq = q.shape
    Lt = t.shape[1]
    cells = global_dp_cells(qlen, tlen, band)
    walk = ((2 * (Lq + Lt) + 7) // 4 * 4 + 3) // 4
    nbytes = cells + q.numel() + t.numel() + 8 * M + walk * M
    return roof_ms(nbytes, OPS_PER_CELL * cells)
