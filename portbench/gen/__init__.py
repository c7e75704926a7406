"""Seeded, vectorised generators: a deployment's reference sequence,
single-end reads and read pairs, and the placement share of records.

Vectorised copies of ``seqlib_tpu_torch/sim.py``'s ``make_genome``,
``simulate_reads``, ``simulate_pairs`` and ``placement_rate``: the same
models, drawn in whole arrays instead of a loop per read (the loop made
920,000 reads in 36.9 s), so the random streams, and with them the
reads of a seed, differ from the originals'."""

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def stream(seed: int, *key: int) -> np.random.Generator:
    """An independent generator for one use (``key``) of a run's seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *key]))
