"""A short run of a cell on the card, cut to a small genome: the result
line, correct, and every per-layer metric read (kernels K1 and K2 run
only there).  Skips without a card; run on the card with

    python -m pytest -m gpu portbench/tests -q
"""

import json

import pytest
import torch

from portbench import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [False, True])
def test_short_run_on_the_card(card, tiny_spec, trace):
    spec = tiny_spec(batch=4096, pool_batches=2, workers=2,
                     check_reads=256, trace_batches=1)
    lines = []
    assert harness.run(spec, 2**33 + 77, 4.0, trace, card,
                       emit=lines.append) == 0
    line = json.loads(lines[0])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert set(line["metrics"]) == {m["name"] for m in spec.per_layer}
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    else:
        assert line["metrics"]["reads_per_s"]["value"] > 0
