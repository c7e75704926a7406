"""Paired-end alignment on the port's wide-index path against the JAX
package's, on the CPU.

``align_pairs`` on ``BWAAligner(wide=True)`` (int64 ranks and positions
on a small index, as tests/test_torch_wide.py sets out) against the JAX
package's ``align_pairs`` on its ``BWAAligner(wide=True)``: 32 pairs of
2 x 150 bp (insert 400 +- 40) over the three-contig repeat reference of
tests/test_torch_wide.py, the mates 2 of pairs 0 and 16 mutated at
period 8, so that only mate rescue places them.  The port runs on the
CPU through the plain versions of its kernels.  Tolerance: exact
equality of every SAM line and of the inferred insert-size statistics.
"""

import numpy as np
import pytest
import torch

from regen_golden import make_repeat_genome
from seqlib_tpu.align import BWAAligner as JaxAligner
from seqlib_tpu.align import pairing as jpair
from seqlib_tpu.index import FMIndex as JaxFMIndex
from seqlib_tpu_torch.align import BWAAligner
from seqlib_tpu_torch.align import pairing as tpair
from seqlib_tpu_torch.index import FMIndex
from seqlib_tpu_torch.sim import simulate_pairs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mutate_period(seq, period):
    out = list(seq)
    for i in range(0, len(seq), period):
        out[i] = {"A": "C", "C": "G", "G": "T", "T": "A"}[out[i]]
    return "".join(out)


@pytest.fixture(scope="module")
def pairs_run():
    """Both packages' wide aligners on the same 32 pairs, each once."""
    g = make_repeat_genome()
    contigs = [("c1", g[:52_000]), ("c2", "N" * 300 + g[52_300:100_000]),
               ("c3", g[100_000:110_000] + "N" * 150 + g[110_150:])]
    r1, r2 = simulate_pairs(contigs, 32, read_len=150, dist=400, stdev=40,
                            seed=12)
    s1, s2 = [u.seq for u in r1], [u.seq for u in r2]
    for i in (0, 16):
        s2[i] = _mutate_period(s2[i], 8)
    names = [u.name for u in r1]
    ja = JaxAligner(JaxFMIndex.construct(contigs), wide=True)
    tw = BWAAligner(FMIndex.construct(contigs), wide=True, device="cpu")
    return (jpair.align_pairs(ja, s1, s2, names),
            tpair.align_pairs(tw, s1, s2, names), tw)


@pytest.mark.parametrize("end", [0, 1])
def test_wide_pairs_sam_equals_jax(pairs_run, end):
    """Each end's SAM lines (flags, mates, TLEN, rescued records) equal the
    JAX package's."""
    want, got, tw = pairs_run
    hdr = tw.index.header_from_index()
    lines = [[r.to_sam(hdr) for rs in out[end] for r in rs]
             for out in (got, want)]
    assert lines[0] == lines[1] and len(lines[0]) >= 32


def test_wide_pairs_stats_and_rescue(pairs_run):
    """The inferred insert-size statistics equal the JAX package's; the
    two seedless mates were rescued into proper pairs."""
    (_, _, jst), (_, to2, tst), tw = pairs_run
    assert tw.wide and tw.fm.blocks.dtype == torch.int64
    for dt, dj in zip(tst.dirs, jst.dirs):
        assert (dt.failed, dt.low, dt.high, dt.avg, dt.std, dt.count) \
            == (dj.failed, dj.low, dj.high, dj.avg, dj.std, dj.count)
    assert all(to2[i] and to2[i][0].proper_pair() for i in (0, 16))
    assert np.isfinite(tst.dirs[tpair.FR].avg)
