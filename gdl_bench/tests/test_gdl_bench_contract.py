"""BENCHMARK.json against the benchmark's contract, and every name found:
each cell's files, and its CPU twin (``tiny.py``)."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "gdl_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["gdl_bench"]
    assert bench["command"] == ["python3", "gdl_bench/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    names += [w["traffic"] for w in bench["workloads"]]
    names += [r for c in bench["configs"] for r in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in bench[k]}) == len(bench[k])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for text in [c["why"] for c in bench["configs"] + bench["workloads"]] + \
            [c["source"] for c in bench["configs"]] + [m["layer"] for m in bench["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    check_chips(bench["workloads"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def check_chips(workloads: list[dict]) -> None:
    """1 or 4 chips a cell, and 4 for at most a quarter of the cells,
    rounded down, or for one."""
    chips = [w["chips"] for w in workloads]
    assert set(chips) <= {1, 4}, chips
    assert chips.count(4) <= max(1, len(chips) // 4), chips


def test_one_four_chip_cell_among_four_and_no_second():
    cells = [{"name": f"cell{i}", "chips": 1} for i in range(4)]
    cells[0]["chips"] = 4
    check_chips(cells)
    cells[1]["chips"] = 4
    with pytest.raises(AssertionError):
        check_chips(cells)
    with pytest.raises(AssertionError):
        check_chips([{"name": "cell", "chips": 2}])


def test_every_cell_reports_what_it_must(bench):
    configs = {c["name"] for c in bench["configs"]}
    assert {w["config"] for w in bench["workloads"]} == configs
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in bench["per_layer"] if w["name"] in m["workloads"]]
        assert layer and all(m["moves"] in e2e for m in layer)


def test_every_name_has_its_files(bench):
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"] == f"gdl_bench/configs/{c['name']}.json"
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(cfg["source"]) <= 200
        assert (BENCH / "reference" / f"{cfg['family']}.py").is_file()
        assert (BENCH / "counts" / f"{cfg['family']}.py").is_file()
    for w in bench["workloads"]:
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['kind']}.py").is_file()
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert cell["limits"]
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_has_a_cpu_twin(bench):
    from gdl_bench.tests import tiny

    found = tiny.twins(ROOT)
    cells = [w["name"] for w in bench["workloads"]]
    missing = [c for c in cells if c not in found]
    assert not missing, f"no CPU twin gdl_bench/tests/twins/<cell>.json for {missing}"
    assert set(found) <= set(cells), sorted(set(found) - set(cells))
    twins = tiny.tiny_cells(ROOT)
    assert len({t["cell"] for t, _ in twins.values()}) == len(twins)
    for w in bench["workloads"]:
        twin, cfg = twins[w["name"]]
        for name in (twin["cell"], twin["config"], twin["traffic"]):
            assert NAME.match(name), name
        tiny_traffic = json.loads(
            (tiny.twin_dir(ROOT) / "traffic" / f"{twin['traffic']}.json").read_text())
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert tiny_traffic["kind"] == traffic["kind"]
        assert twin["faults"] and cfg["family"]


def test_metric_files_agree(bench):
    from gdl_bench import harness

    for m in bench["per_layer"]:
        reader = harness.load_file_module(BENCH / "metrics" / f"{m['name']}.py")
        assert (reader.SOURCE, reader.LAYER, reader.MOVES) == (m["source"], m["layer"], m["moves"])


def test_budget_fits(bench):
    """24 cells at this window length fit the check's 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
