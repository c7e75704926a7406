"""The check's control (control.py: the reference in the port's place,
bwa's clipping penalty -L 5,5 dropped to 0), driven through a run of the
cell, comes out as not correct on every seed, at a size a test run can
hold."""

import json

import pytest
import torch

from portbench import harness


@pytest.mark.parametrize("seed", [101, 102, 2**33 + 103])
def test_control_fails_the_check(tiny_spec, seed):
    spec = tiny_spec(batch=256, check_reads=200)
    lines = []
    rc = harness.run(spec, seed, 0.0, False, torch.device("cpu"),
                     emit=lines.append, control=True)
    assert rc == 0 and len(lines) == 1
    line = json.loads(lines[0])
    assert line["attempted"] == 256
    assert line["correct"] is False
    assert line["checks"]["reads_differing"]["value"] > 0
