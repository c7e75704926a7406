"""A deployment's reference sequence from a seed.

Each contig is ``make_genome``'s model (``seqlib_tpu_torch/sim.py``): a
uniform random sequence with, per segment, two exact copies and one
1%-divergent copy of a random ``seg_len`` block at evenly spaced slots,
then one tandem block of ``tandem_copies`` units of ``tandem_unit``
bases.  A configuration gives the contigs' names and lengths and the
segments per Mbp (``genome_model``)."""

from __future__ import annotations

import numpy as np

from . import BASES, stream


def make_contig(length: int, rng: np.random.Generator, n_segments: int,
                seg_len: int = 5000, tandem_unit: int = 60,
                tandem_copies: int = 50) -> np.ndarray:
    """One contig as nt4 codes (uint8 0..3), ``make_genome``'s model."""
    g = rng.integers(0, 4, length, dtype=np.uint8)
    stride = length // (3 * n_segments + 2)
    slot = 1
    for _ in range(n_segments):
        seg = rng.integers(0, 4, seg_len, dtype=np.uint8)
        div = seg.copy()
        nmut = seg_len // 100
        muts = rng.choice(seg_len, nmut, replace=False)
        div[muts] = (div[muts] + rng.integers(1, 4, nmut)) % 4
        for copy in (seg, seg, div):
            g[slot * stride:slot * stride + seg_len] = copy
            slot += 1
    unit = rng.integers(0, 4, tandem_unit, dtype=np.uint8)
    t0 = slot * stride
    block = np.tile(unit, tandem_copies)[:max(0, length - t0)]
    g[t0:t0 + block.size] = block
    return g


def make_genome(config: dict, seed: int) -> list[tuple[str, np.ndarray]]:
    """[(contig name, nt4 codes)] of a configuration, from ``seed``."""
    model = config["genome_model"]
    out = []
    for i, (name, length) in enumerate(config["contigs"]):
        n_seg = int(length * model["segments_per_mbp"] / 1e6)
        # every copy has a slot of its own: stride >= seg_len
        n_seg = min(n_seg, max(0, (length // model["seg_len"] - 2) // 3))
        out.append((name, make_contig(
            int(length), stream(seed, 1, i), n_seg, model["seg_len"],
            model["tandem_unit"], model["tandem_copies"])))
    return out


def as_text(codes: np.ndarray) -> str:
    """nt4 codes -> an ACGT string."""
    return BASES[codes].tobytes().decode()
