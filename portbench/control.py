"""The control of the aligner cells' check: the reference put in the
port's place with one guarantee that the configuration states broken,
driven through a run of the cell (``harness.run(..., control=True)``),
whose check then has to come out as not correct.

The guarantee: bwa mem's end clipping, ``-L 5,5``.  The control sets
the clipping penalty to 0 (``pen_clip5 = pen_clip3 = 0``): a read's
alignment is clipped wherever its local best beats its end-to-end
score, as an extension that dropped the end-to-end score (``gscore``)
to go faster would.  A control run sets up the cell as a run does (the
genome, the read pool and the reference's index from the seed), puts
``ControlAligner`` where the port's aligner goes, streams
``control_batches`` batches of the cell's size through it on the card,
and runs the run's own check on what it yielded.  Run it on the card at
the cell's size, several seeds in one process:

    python3 portbench/control.py --workload ecoli-k12.se150 \\
        --seeds 11,12,13

It prints each run's result line; each has to read ``correct: false``."""

from __future__ import annotations

import argparse
import os
import sys

CONTROL = {"pen_clip5": 0, "pen_clip3": 0}


class ControlAligner:
    """The reference with ``CONTROL`` in place of the port's aligner:
    ``align_stream_bam`` yields (reads, BAM payload, records per read)
    for each batch of ``batch_size`` reads of ``feed``."""

    def __init__(self, index, options: dict, device):
        from portbench.reference.bwamem.align.aligner import BWAAligner
        from portbench.reference.bwamem.align.options import AlignerOptions
        self.aligner = BWAAligner(
            index, options=AlignerOptions(**dict(options, **CONTROL)),
            device=device)
        self.stats = self.aligner.stats

    def reset_stats(self) -> None:
        self.aligner.reset_stats()

    def align_stream_bam(self, feed, batch_size: int, workers: int = 1,
                         sam: bool = False):
        import numpy as np

        from portbench.reference.bwamem.io.bam import encode_record
        chunk = []
        for read in feed:
            chunk.append(read)
            if len(chunk) == batch_size:
                yield self._batch(chunk, encode_record, np)
                chunk = []
        if chunk:
            yield self._batch(chunk, encode_record, np)

    def _batch(self, chunk, encode_record, np):
        recs = self.aligner.align_batch([r.seq for r in chunk],
                                        [r.name for r in chunk])
        counts = np.array([len(rs) for rs in recs], np.int32)
        payload = b"".join(encode_record(r) for rs in recs for r in rs)
        return chunk, payload, counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    from portbench import harness
    spec = harness.load_spec(args.workload)
    try:
        device = harness.card(spec.chips)
    except harness.NoCard as e:
        harness.log(f"portbench: {e}")
        return 3
    rc = 0
    for s in args.seeds.split(","):
        rc |= harness.run(spec, int(s), 0.0, False, device, control=True)
    return rc


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
