import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def tiny_spec():
    """A cell of BENCHMARK.json cut to a size the CPU tests can run: two
    short contigs and batches of 64 reads."""
    from portbench import harness

    def make(cell="ecoli-k12.se150", **traffic):
        spec = harness.load_spec(cell)
        spec.config = dict(spec.config,
                           contigs=[["c1", 120000], ["c_2", 50000]])
        spec.traffic = dict(spec.traffic, **dict(
            dict(batch=64, pool_batches=2, workers=1, check_reads=48,
                 trace_batches=1), **traffic))
        return spec
    return make
