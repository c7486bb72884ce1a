"""Every cell finds its configuration, mix, driver, builder and metric
readers by name; a bad or missing name is refused."""

import json
import os

import pytest

from harness import spec

with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as fh:
    BENCH = json.load(fh)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_finds_its_files(workload):
    cell = spec.load_cell(workload)
    spec.load_module("drivers", cell.traffic["driver"])
    spec.load_module("builders", cell.config["builder"])
    for m in cell.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert cell.config["name"] == cell.config_name


def test_every_metric_has_a_reader_and_a_cell():
    for m in BENCH["per_layer"]:
        spec.load_module("metrics", m["name"])
        assert set(m["workloads"]) <= set(CELLS)
    for c in BENCH["configs"]:
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("bad", ["", "no/slash", "a b", "-lead", "x" * 65, "../up", "tab\t"])
def test_bad_names_are_refused(bad):
    with pytest.raises(spec.SpecError):
        spec.check_name(bad, "workload")
    with pytest.raises(spec.SpecError):
        spec.load_cell(bad)


def test_missing_files_are_refused():
    with pytest.raises(spec.SpecError, match="no workload"):
        spec.load_cell("no.such.cell")
    with pytest.raises(spec.SpecError, match="missing"):
        spec.load_module("metrics", "no_such_metric")
    bench = {**BENCH, "workloads": [{**BENCH["workloads"][0], "traffic": "no_such_mix"}]}
    with pytest.raises(spec.SpecError, match="traffic mix"):
        spec.load_cell(BENCH["workloads"][0]["name"], bench)
    bench = {**BENCH, "workloads": [{**BENCH["workloads"][0], "config": "no_such_config"}]}
    with pytest.raises(spec.SpecError, match="does not list"):
        spec.load_cell(BENCH["workloads"][0]["name"], bench)
