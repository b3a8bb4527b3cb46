"""A run end to end on the CPU at tiny sizes (the look for a card skipped),
the planted faults and the control against the cells' limits, and a cell,
configuration, traffic mix and metric added by files alone."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from gdl_bench import harness
from gdl_bench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 12345  # more than 32 signed bits hold
_TWINS = [t for t, _ in tiny.tiny_cells().values()]
TWINS = sorted(t["cell"] for t in _TWINS)
FAULTS = [(t["cell"], f) for t in _TWINS for f in t["faults"]]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tiny.register()
    return tiny.tiny_tree(tmp_path_factory.mktemp("bench"))


def _run(tree, cell, trace=False, **kw):
    return harness.run(cell, SEED, 0.5, trace, torch.device("cpu"), time.perf_counter(), tree,
                       **kw)


def _cli(args, cwd, **env):
    return subprocess.run([sys.executable, "gdl_bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", **env})


def test_no_card_no_result():
    out = _cli(["--workload", "dofa_base-train-b32", "--seed", str(SEED), "--seconds", "1",
                "--trace", "0"], ROOT)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_bytecode_kept_in_the_checkout(tmp_path):
    """With bytecode turned off in the environment, a run still keeps its
    modules' bytecode, torch's among them, under its checkout's
    ``build/gdl_bench/pycache``, so that only a checkout's first run
    compiles them."""
    root = tiny.source_copy(tmp_path)
    out = _cli(["--workload", "dofa_base-train-b32", "--seed", "1", "--seconds", "1",
                "--trace", "0"], root, PYTHONDONTWRITEBYTECODE="1")
    assert out.returncode != 0  # no card here
    cached = root / "build" / "gdl_bench" / "pycache"
    assert [p for p in cached.rglob("__init__.*.pyc") if p.parent.name == "torch"]


def test_benchmark_alone_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gdl_bench", tmp_path / "gdl_bench")
    out = _cli(["--workload", "dofa_base-train-b32", "--seed", "1", "--seconds", "1",
                "--trace", "0"], tmp_path)
    assert out.returncode != 0
    assert "correct" not in out.stdout


@pytest.mark.parametrize("cell", TWINS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tree, cell, trace):
    r = _run(tree, cell, trace)
    assert list(r)[-1] == "compared"
    assert set(r) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert r["attempted"] > 0 and r["failed"] == 0
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    e2e, layer = harness.cell_metrics(bench, cell)
    if trace:
        # on the CPU the device-trace readers find nothing and are left out
        assert set(r["metrics"]) <= {m["name"] for m in layer}
        assert {m["name"] for m in layer if m["source"] == "host_clock"} <= set(r["metrics"])
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {m["name"] for m in e2e}
    for v in r["compared"].values():
        assert set(v) == {"value", "limit"}


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(tree, cell, fault):
    assert _run(tree, cell, fault=fault)["correct"] is False


@pytest.mark.parametrize("cell", TWINS)
def test_the_control_fails_a_limit(tree, cell):
    """The reference in fp8, in the program's place, exceeds one of the
    cell's limits."""
    r = _run(tree, cell, control=True)
    limits = {k: v["limit"] for k, v in r["compared"].items()}
    assert any(r["control"][k] > limits[k] for k in limits), (r["control"], limits)


def test_files_alone_add_a_cell_and_a_metric(tree, tmp_path):
    """A configuration, traffic mix, cell and per-layer metric added by new
    files and BENCHMARK.json entries; no existing file of gdl_bench edited."""
    root = tmp_path / "checkout"
    shutil.copytree(tree, root)
    b = root / "gdl_bench"
    cfg = json.loads((b / "configs" / "dofa_tiny.json").read_text())
    cfg["name"] = "dofa_tiny_wide"
    cfg["port"]["init_args"]["decoder_channels"] = cfg["decoder_channels"] = 24
    (b / "configs" / "dofa_tiny_wide.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "train-tiny.json").read_text())
    (b / "traffic" / "train-tiny-b2.json").write_text(json.dumps({**traffic, "batch": 2}))
    (b / "workloads" / "wide-train-b2.json").write_text(
        (b / "workloads" / "dofa_tiny-train.json").read_text())
    (b / "metrics" / "steps_seen.train.py").write_text(
        'SOURCE = "host_clock"\nLAYER = "training.loop"\nMOVES = "train_patches_per_s"\n'
        'OPS = ()\n\n\ndef read(rec, ctx):\n    return float(rec["steps"])\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "dofa_tiny_wide",
                             "file": "gdl_bench/configs/dofa_tiny_wide.json"})
    bench["workloads"].append({"name": "wide-train-b2", "config": "dofa_tiny_wide",
                               "traffic": "train-tiny-b2", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "train_patches_per_s" == m["name"]:
            m["workloads"].append("wide-train-b2")
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "training.loop",
                               "moves": "train_patches_per_s", "workloads": ["wide-train-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = _run(root, "wide-train-b2", trace=True)
    assert r["metrics"]["steps_seen.train"]["value"] >= 1
    assert _run(root, "wide-train-b2")["metrics"]["train_patches_per_s"]["value"] > 0
