"""A run of a cell, driven on the CPU at a tiny size with the harness's
look for a card skipped: the contract's last line, and ``correct``
false when the timed path is broken underneath."""

import json

import numpy as np
import pytest
import torch

from portbench import harness
from seqlib_tpu_torch.align import BWAAligner

SEED = 2**33 + 9


def _run(spec, trace=False, seconds=8.0):
    lines = []
    rc = harness.run(spec, SEED, seconds, trace, torch.device("cpu"),
                     emit=lines.append)
    assert rc == 0 and len(lines) == 1
    return json.loads(lines[0])


@pytest.mark.parametrize("cell", ["ecoli-k12.se150",
                                  "ecoli-k12.se150.fullsa"])
def test_line_shape(tiny_spec, cell):
    spec = tiny_spec(cell)
    line = _run(spec)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 64
    assert set(line["metrics"]) == {"reads_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["metrics"]["reads_per_s"]["unit"] == "reads/s"
    assert line["device"]["count"] == 1
    assert line["checks"]["reads_differing"] == {"value": 0, "limit": 0}


def test_traced_line_shape(tiny_spec):
    line = _run(tiny_spec(), trace=True)
    assert line["correct"] is True
    names = {m["name"] for m in harness.load_spec(
        "ecoli-k12.se150").per_layer}
    # on the CPU the kernels and the device trace have nothing to read
    assert {"host_ms_per_batch", "locate_ms_per_batch",
            "global_dp_ms_per_batch"} <= set(line["metrics"]) <= names
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _broken(kind):
    orig = BWAAligner._payload_batch

    def payload_batch(self, chunk, *a, **kw):
        payload, counts = orig(self, chunk, *a, **kw)
        counts = np.asarray(counts).copy()
        recs, off = [], 0
        for c in counts.tolist():
            one = []
            for _ in range(c):
                size = int.from_bytes(payload[off:off + 4], "little")
                one.append(bytearray(payload[off:off + 4 + size]))
                off += 4 + size
            recs.append(one)
        if kind == "half":
            # half of the batch left out: no records for its second half
            for i in range(len(recs) // 2, len(recs)):
                recs[i] = []
        else:
            # an answer altered where it is produced: every 7th read's
            # records one base to the right
            for i in range(0, len(recs), 7):
                for r in recs[i]:
                    pos = int.from_bytes(r[8:12], "little", signed=True)
                    r[8:12] = (pos + 1).to_bytes(4, "little", signed=True)
        return (b"".join(bytes(r) for one in recs for r in one),
                np.array([len(one) for one in recs], np.int32))
    return payload_batch


@pytest.mark.parametrize("kind", ["half", "altered"])
def test_broken_path_is_not_correct(tiny_spec, monkeypatch, kind):
    monkeypatch.setattr(BWAAligner, "_payload_batch", _broken(kind))
    line = _run(tiny_spec())
    assert line["correct"] is False
    assert line["checks"]["reads_differing"]["value"] > 0
    if kind == "half":
        assert line["failed"] > line["checks"]["reads_differing"]["value"]


def test_forbidden_module_refuses_the_result(tiny_spec, monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    lines = []
    rc = harness.run(tiny_spec(), SEED, 8.0, False, torch.device("cpu"),
                     emit=lines.append)
    assert rc != 0 and lines == []


def test_index_files_cached_per_seed_outside_setup(tiny_spec, tmp_path,
                                                   monkeypatch):
    """bwa's files of a loaded index are written once per seed, by the
    reference, and their time is not set-up's; the cache keeps one seed."""
    from portbench.clients import se_stream
    monkeypatch.setattr(se_stream, "CACHE", str(tmp_path))
    spec = tiny_spec()
    dev = torch.device("cpu")
    first = se_stream.Cell(spec, SEED, dev, lambda *a: None)
    assert first.ref is not None and "load" in first.setup_parts
    assert first.untimed["bwa_index_files"] > 0
    again = se_stream.Cell(spec, SEED, dev, lambda *a: None)
    assert again.ref is None      # the files were there: nothing built
    assert again.untimed["bwa_index_files"] < \
        first.untimed["bwa_index_files"]
    se_stream.Cell(spec, SEED + 1, dev, lambda *a: None)
    top = tmp_path / spec.config["name"]
    assert sorted(p.name for p in top.iterdir()) == [str(SEED + 1)]
