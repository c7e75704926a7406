"""Reads/s over mesh sizes (counterpart of seqlib_tpu/parallel/scaling.py).

Times the production stage that ``BWAAligner(mesh=...)`` runs for a
batch, the fused program on every slice at once (``_dispatch_full``),
at mesh sizes 1..n, and reports reads/s and the parallel efficiency
(reads/s over n times the 1-entry mesh's).  On ``device="cuda"`` a mesh
of n is the first n cards; on one named device (``"cuda:0"``, ``"cpu"``)
it is n replicas of the work on that device, which measures the host's
overlap of the replicas, not scaling over cards.  Run as a module for a
report on a synthetic reference (``sim.make_genome``):

    python -m seqlib_tpu_torch.parallel.scaling [--device cuda:0]
"""

from __future__ import annotations

import time

import numpy as np
import torch


def measure_scaling(index, reads: np.ndarray, lens: np.ndarray,
                    sizes=None, iters: int = 3, device="cuda") -> list:
    """index: host FMIndex; reads [B, L] nt4 codes, lens [B] (B divisible
    by every mesh size).  Returns one dict per size: {n_devices,
    reads_per_s, efficiency}.  ``sizes`` defaults to 1, 2, 4, 8 up to
    the cards of the host on ``"cuda"``, and to [1, 2] on one named
    device."""
    from ..align.aligner import BWAAligner
    from .mesh import make_mesh
    dev = torch.device(device)
    if sizes is None:
        have = torch.cuda.device_count() \
            if dev.type == "cuda" and dev.index is None else 2
        sizes = [s for s in (1, 2, 4, 8) if s <= have]
    out = []
    base = None
    for n in sizes:
        aln = BWAAligner(index, mesh=make_mesh(n, device=device))
        if reads.shape[0] % n:
            raise ValueError(f"measure_scaling: {reads.shape[0]} reads do "
                             f"not divide over {n} entries")

        def sync():
            for d in aln.mesh.distinct():
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

        aln._dispatch_full(reads, lens)          # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            aln._dispatch_full(reads, lens)
        sync()
        dt = (time.perf_counter() - t0) / iters
        rps = reads.shape[0] / dt
        if base is None:
            base = rps
        out.append(dict(n_devices=n, reads_per_s=round(rps, 1),
                        efficiency=round(rps / (base * n), 3)))
    return out


def _main(argv=None):
    import argparse
    from ..align.aligner import BWAAligner
    from ..index import FMIndex
    from ..sim import make_genome, simulate_reads
    from .mesh import make_mesh

    ap = argparse.ArgumentParser(prog="seqlib_tpu_torch.parallel.scaling")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--genome-bp", type=int, default=4_600_000)
    ap.add_argument("--reads", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=3)
    a = ap.parse_args(argv)
    genome = make_genome(a.genome_bp, seed=7)
    idx = FMIndex.construct([("sim_chr", genome)])
    sel = simulate_reads(genome, a.reads, seed=11)
    one = BWAAligner(idx, mesh=make_mesh(1, device=a.device))
    enc, lens = one._encode_batch([s for _, s in sel])
    for row in measure_scaling(idx, enc, lens, iters=a.iters,
                               device=a.device):
        print(row)


if __name__ == "__main__":
    _main()
