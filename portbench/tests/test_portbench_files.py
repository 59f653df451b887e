"""BENCHMARK.json and the files it names: every cell and configuration
parses and is found by name, every metric has its reader, and a cell added
as files alone is picked up."""
from __future__ import annotations

import importlib
import json
import re

import pytest

from support_portbench import ROOT
from portbench.lib import bench, config

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    cell = bench.load_cell(ROOT, w["name"])
    assert cell.spec["config"] == w["config"] and w["chips"] == 1
    assert NAME.match(w["name"]) and len(w["why"]) <= 200
    assert importlib.import_module(f"portbench.loops.{cell.spec['loop']}")
    assert set(cell.spec["limits"]) <= set(
        importlib.import_module("portbench.lib.check").NUMBERS)
    untraced = bench.cell_metrics(ROOT, w["name"], trace=False)
    traced = bench.cell_metrics(ROOT, w["name"], trace=True)
    assert "setup_s" in [m["name"] for m in untraced] and len(untraced) > 1
    assert traced


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_parses(c):
    conf = config.load_json(ROOT / c["file"])
    d = config.dims_of(conf)
    assert d.n_heads % d.n_kv_heads == 0 and d.dtype == "bfloat16"
    assert conf["source"] == c["source"]
    assert c["reduced"] == conf["reduced"] + list(conf.get("departures", {}))
    for key in c["reduced"]:
        assert key in conf["published"]
        assert not key.endswith(("_dim", "_rank", "_size"))


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_has_a_reader(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    mod = importlib.import_module(f"portbench.metrics.{m['name']}")
    assert callable(mod.read)
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
    if "moves" in m:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]


def test_cell_added_as_files_alone_is_found(smoke_root):
    for name in ("cell_yi_smoke", "cell_qwen_smoke"):
        cell = bench.load_cell(smoke_root, name)
        assert cell.dims.d_model == 64
        assert [m["name"] for m in bench.cell_metrics(smoke_root, name,
                                                       trace=True)] == [
            m["name"] for m in BENCH["per_layer"]]
    with pytest.raises(KeyError):
        bench.load_cell(smoke_root, "no_such_cell")
