"""Every cell, configuration, traffic mix and metric of BENCHMARK.json
loads by name and names what exists."""

import json
import os
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
LAYERS = {"host stream", "device program", "seed and locate",
          "global DP and traceback", "kernel K1", "kernel K2", "device"}


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert os.path.exists(os.path.join(ROOT, BENCH["command"][1]))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads(cell):
    spec = harness.load_spec(cell)
    assert spec.chips == 1
    assert spec.config["name"] == [w for w in BENCH["workloads"]
                                   if w["name"] == cell][0]["config"]
    assert os.path.exists(os.path.join(
        ROOT, "portbench", "clients", spec.traffic["client"] + ".py"))
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"}
    assert len(spec.end_to_end) >= 2 and spec.per_layer


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    cfg = json.load(open(os.path.join(ROOT, conf["file"])))
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"]
    assert conf["file"].startswith("portbench/configs/")
    assert all(int(n) > 0 for _, n in cfg["contigs"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(metric):
    mod = harness.metric_module(metric["name"])
    assert callable(mod.read)
    assert metric["layer"] in LAYERS
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(metric["workloads"]) <= set(CELLS)
    if metric["unit"] == "%" and "roofline" in metric["name"]:
        assert metric["name"].endswith("_roofline")


def test_unknown_cell():
    with pytest.raises(KeyError):
        harness.load_spec("no-such-cell")


def test_no_card_exits_without_a_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", CELLS[0], "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
