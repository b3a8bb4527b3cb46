"""A configuration and its cells join the benchmark by new files and
``BENCHMARK.json`` entries alone: the reference loss that the
configuration names, masks that a one-class head can learn from, and a
CPU twin found by the cell's name."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from gdl_bench import harness, weights
from gdl_bench.drivers import train
from gdl_bench.reference.common import LOSSES, dice_binary, dice_loss, loss_of
from gdl_bench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 4321
MIT = "segformer_mit_b2-train-b32"
BINARY = "segformer_mit_b2_binary"
BINARY_CELL = f"{BINARY}-train-b32"
WIDER_CELL = "segformer_mit_b2-train-b16"


def _write(path: Path, data: dict) -> None:
    path.write_text(json.dumps(data, indent=1))


def _join(root: Path, cell: dict, like: str) -> None:
    """``cell``'s BENCHMARK.json entry, with the cell named in every metric's
    ``workloads`` that names ``like``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(cell["name"])
    _write(root / "BENCHMARK.json", bench)


def add_binary_cell(root: Path) -> None:
    """The UNet++ recipe's head on the MiT cell: one class, binary Dice; a
    configuration, a cell, its twin and their entries, all new."""
    b = root / "gdl_bench"
    cfg = json.loads((b / "configs" / "segformer_mit_b2.json").read_text())
    cfg.update(name=BINARY, num_classes=1, loss="dice_binary")
    cfg["port"]["init_args"]["num_classes"] = 1
    _write(b / "configs" / f"{BINARY}.json", cfg)
    shutil.copy(b / "workloads" / f"{MIT}.json", b / "workloads" / f"{BINARY_CELL}.json")
    twin = json.loads((tiny.twin_dir(root) / f"{MIT}.json").read_text())
    # in f32, so that on the CPU the program and the reference agree to
    # rounding at the cell's own limits (CPU bf16 moves the tiny network's
    # gradients further than the card's does)
    twin.update(cell="mit_tiny_binary-train", config="mit_tiny_binary")
    twin["overrides"]["precision"] = "32-true"
    _write(tiny.twin_dir(root) / f"{BINARY_CELL}.json", twin)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "segformer_mit_b2")
    bench["configs"].append({**entry, "name": BINARY, "file": f"gdl_bench/configs/{BINARY}.json"})
    _write(root / "BENCHMARK.json", bench)
    _join(root, {"name": BINARY_CELL, "config": BINARY, "traffic": "train-b32", "chips": 1,
                 "why": "one class, binary Dice"}, MIT)


def add_wider_cell(root: Path) -> None:
    """A cell of the MiT configuration at bs 16: its traffic, limits and twin,
    all new."""
    b = root / "gdl_bench"
    traffic = json.loads((b / "traffic" / "train-b32.json").read_text())
    _write(b / "traffic" / "train-b16.json", {**traffic, "batch": 16})
    shutil.copy(b / "workloads" / f"{MIT}.json", b / "workloads" / f"{WIDER_CELL}.json")
    tiny_traffic = json.loads((tiny.twin_dir(root) / "traffic" / "train-tiny.json").read_text())
    _write(tiny.twin_dir(root) / "traffic" / "train-tiny-b6.json", {**tiny_traffic, "batch": 6})
    twin = json.loads((tiny.twin_dir(root) / f"{MIT}.json").read_text())
    twin.update(cell="mit_tiny-train-b6", traffic="train-tiny-b6")
    _write(tiny.twin_dir(root) / f"{WIDER_CELL}.json", twin)
    _join(root, {"name": WIDER_CELL, "config": "segformer_mit_b2", "traffic": "train-b16",
                 "chips": 1, "why": "bs 16"}, MIT)


def _unchanged(source: Path) -> None:
    """No file that the checkout's benchmark has was edited in ``source``."""
    for path in (ROOT / "gdl_bench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert path.read_bytes() == (source / path.relative_to(ROOT)).read_bytes(), path


def _run(root: Path, cell: str, **kw) -> dict:
    return harness.run(cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter(), root,
                       **kw)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 99])
def test_dice_binary_matches_the_port(seed):
    from geo_deep_learning_tpu_torch.ops.losses import DiceLoss

    g = torch.Generator().manual_seed(seed)
    logits = 3 * torch.randn(4, 1, 24, 24, generator=g)
    target = torch.randint(0, 2, (4, 24, 24), generator=g)
    ours, port = logits.clone().requires_grad_(), logits.clone().requires_grad_()
    want = DiceLoss(mode="binary")(port, target)
    got = LOSSES["dice_binary"](ours, target, 1)
    want.backward()
    got.backward()
    torch.testing.assert_close(got, want, rtol=2e-6, atol=0)
    torch.testing.assert_close(ours.grad, port.grad, rtol=1e-5,
                               atol=1e-6 * float(port.grad.abs().max()))


def test_the_losses_by_name():
    assert LOSSES["dice_multiclass"] is dice_loss
    assert loss_of({"loss": "dice_binary"}) is dice_binary
    with pytest.raises(ValueError, match='"loss"'):
        loss_of({"name": "x", "loss": "dice_focal"})
    with pytest.raises(ValueError, match='"loss"'):
        loss_of({"name": "x"})
    with pytest.raises(ValueError):
        dice_binary(torch.zeros(1, 2, 4, 4), torch.zeros(1, 4, 4, dtype=torch.long), 2)


TRAFFIC = {"batch": 3, "pool_batches": 2, "mask_block": 4}


@pytest.mark.parametrize("seed", [1, 12345, 2 ** 31 + 5])
def test_the_pool_of_a_multiclass_head_is_as_it_was(seed):
    cfg = {"image_size": 32, "in_channels": 3, "num_classes": 5, "mean": [0.0] * 3,
           "std": [1.0] * 3}
    pool = train.make_pool(TRAFFIC, cfg, seed, torch.device("cpu"))
    g = torch.Generator(device="cpu").manual_seed(weights.derive(seed, 2))
    img = torch.randint(0, 256, (2, 3, 32, 32, 3), generator=g, dtype=torch.uint8)
    cls = torch.randint(0, 5, (2, 3, 8, 8), generator=g, dtype=torch.uint8)
    mask = cls.repeat_interleave(4, 2).repeat_interleave(4, 3)
    for i, batch in enumerate(pool):
        assert torch.equal(batch["image"], img[i]) and torch.equal(batch["mask"], mask[i])


@pytest.mark.parametrize("seed", [1, 12345, 2 ** 31 + 5])
def test_the_masks_of_a_binary_head_hold_both_classes(seed):
    cfg = {"image_size": 32, "in_channels": 3, "num_classes": 1, "mean": [0.0] * 3,
           "std": [1.0] * 3}
    for batch in train.make_pool(TRAFFIC, cfg, seed, torch.device("cpu")):
        assert set(batch["mask"].unique().tolist()) == {0, 1}


def test_an_unknown_loss_stops_set_up(tmp_path):
    tiny.register()
    root = tiny.tiny_tree(tmp_path)
    path = root / "gdl_bench" / "configs" / "mit_tiny.json"
    cfg = json.loads(path.read_text())
    path.write_text(json.dumps({**cfg, "loss": "dice_focal"}))
    with pytest.raises(ValueError, match="dice_focal"):
        _run(root, "mit_tiny-train")


def test_a_binary_cell_joins_by_new_files(tmp_path):
    """A one-class ``dice_binary`` twin of the MiT cell runs correct on the
    CPU, and its planted faults each fail a limit."""
    source = tiny.source_copy(tmp_path)
    add_binary_cell(source)
    _unchanged(source)
    tiny.register(source)
    root = tiny.tiny_tree(tmp_path / "tiny", source=source)
    cfg = json.loads((root / "gdl_bench" / "configs" / "mit_tiny_binary.json").read_text())
    assert (cfg["num_classes"], cfg["loss"]) == (1, "dice_binary")
    r = _run(root, "mit_tiny_binary-train")
    assert r["correct"] is True, r["compared"]
    for fault in ("half_batch", "unchanged"):
        r = _run(root, "mit_tiny_binary-train", fault=fault)
        assert any(v["value"] > v["limit"] for v in r["compared"].values()), (fault, r)


def _pytest(source: Path, tmp: Path, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                           f"--basetemp={tmp}", *args], cwd=source, capture_output=True,
                          text=True, timeout=1200)


def test_a_cell_joins_with_its_twin(tmp_path):
    """With a cell, its files and its twin added, every CPU test of the
    benchmark passes; without the twin, the contract names the cell."""
    source = tiny.source_copy(tmp_path)
    add_wider_cell(source)
    _unchanged(source)
    this = f"gdl_bench/tests/{Path(__file__).name}::test_a_cell_joins_with_its_twin"
    out = _pytest(source, tmp_path / "all", "gdl_bench/tests", "-m", "not cuda",
                  "--deselect", this)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    assert "mit_tiny-train-b6" in _pytest(source, tmp_path / "ids", "--collect-only",
                                          "gdl_bench/tests/test_gdl_bench_run.py").stdout
    (tiny.twin_dir(source) / f"{WIDER_CELL}.json").unlink()
    out = _pytest(source, tmp_path / "contract",
                  "gdl_bench/tests/test_gdl_bench_contract.py::test_every_cell_has_a_cpu_twin")
    assert out.returncode != 0 and WIDER_CELL in out.stdout, out.stdout[-4000:]
