"""Cells, configurations, model families, traffic mixes and per-layer
readers are found by the names in BENCHMARK.json, and every name obeys the
benchmark's rules."""
import importlib
import os
import re

import pytest

from benchmark import families, harness
from benchmark.tests.tiny import load_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load_bench()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    w, conf, config, traffic = harness.find_cell(cell, BENCH)
    assert w["name"] == cell and conf["name"] == w["config"]
    importlib.import_module("benchmark.loops." + traffic["loop"])
    ref = importlib.import_module("benchmark.reference."
                                  + config["reference"])
    assert callable(ref.render_image) and callable(ref.weight_spec)
    e2e, layer = harness.cell_metrics(BENCH, w)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    assert all(m["moves"] in names for m in layer)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_family_found_by_name(config):
    conf = next(c for c in BENCH["configs"] if c["name"] == config)
    name = harness.load_json(os.path.join(harness.ROOT,
                                          conf["file"]))["reference"]
    mod = families.find(name)
    assert mod.__name__ == "benchmark.families." + name
    assert families.API == ("write_extra", "geometry", "train_work",
                            "render_work")
    for f in families.API:
        assert callable(getattr(mod, f)), f


def test_unknown_cell_refused():
    with pytest.raises(harness.CellError):
        harness.find_cell("no_such.cell", BENCH)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_found_by_name(metric):
    assert callable(harness.load_reader(metric))


def test_names_units_and_paths():
    items = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for it in items:
        assert NAME.match(it["name"]), it["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    assert 1 <= BENCH["run_seconds"] <= 51
