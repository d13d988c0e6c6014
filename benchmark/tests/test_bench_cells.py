"""Cells are found from files by name, and BENCHMARK.json keeps to the
contract's shapes."""

import importlib.util
import json
import re
from pathlib import Path

import pytest

from benchmark import cells, check

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    cell = cells.find(w["name"])
    assert cell.config["name"] == w["config"]
    assert cell.lanes > 0 and cell.chips == w["chips"] == 1
    names = {m["name"] for m in cell.end_to_end}
    assert {"updates_per_s", "step_ms_p90", "peak_mem_gib",
            "setup_s"} <= names
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        spec = importlib.util.spec_from_file_location(
            m["name"], HERE / "metrics" / f"{m['name']}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        assert callable(module.read)
    assert (HERE / "work" / f"{cell.config['net']['type'].lower()}.py"
            ).exists()
    assert cell.driver.__name__ == f"benchmark.drivers.{cell.traffic['kind']}"
    lims = check.limits(cell.name)
    assert lims and all(v >= 0 for v in lims.values())


def test_kernel_metrics_go_to_their_cells():
    mlp = {m["name"] for m in cells.find("mlp256-demo.train-b262k").per_layer}
    flag = {m["name"] for m in cells.find("flagship3.train-b65k").per_layer}
    assert "k1_roofline" in mlp and "k3_roofline" not in mlp
    assert "k3_roofline" in flag and "k1_roofline" not in flag


def test_unknown_cell():
    with pytest.raises(SystemExit):
        cells.find("no.such-cell")


@pytest.mark.parametrize("kind", ["sweep", None])
def test_unknown_traffic_kind(kind):
    with pytest.raises(SystemExit, match="no driver of traffic kind"):
        cells.driver(kind)


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    named = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    assert all(NAME.match(x["name"]) for x in named)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
