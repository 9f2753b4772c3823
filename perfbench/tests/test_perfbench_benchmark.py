"""`BENCHMARK.json` against the benchmark's contract, and the files the
harness finds by the names in it."""

import json
import re

import pytest

from perfbench.run import BENCH, ROOT, cell_metrics, reader_path

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"] and len(SPEC["command"]) <= 32
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51 and (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert reader_path(m["name"]).is_file()
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        # every cell of a per-layer metric reports the metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", CELLS))


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_has_its_files_and_metrics(cell):
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    traffic = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    assert traffic["config"] == w["config"] and w["chips"] == 1
    assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    cfg = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert (ROOT / cfg["file"]).is_file() and cfg["reduced"] == []
    e2e = [m["name"] for m in cell_metrics(SPEC, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell_metrics(SPEC, cell, True)
    assert traffic["limits"] and all(v >= 0 for v in traffic["limits"].values())
