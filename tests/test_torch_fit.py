"""The port's ``fit`` / ``validate`` / ``test`` subcommands end to end on
the CPU: a tiny DOFA + UperNet on a synthetic GeoTIFF dataset with
``trn`` / ``val`` / ``tst`` splits, through ``run(config, ...)`` as a user
calls it, with the port config's trainer, optimizer and scheduler."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_tiny import register_tiny

from geo_deep_learning_tpu_torch.cli import main as cli
from geo_deep_learning_tpu_torch.cli.config import load_config
from geo_deep_learning_tpu_torch.data.geotiff import write_geotiff

ROOT = Path(__file__).resolve().parents[1]
PORT_CONFIG = ROOT / "geo_deep_learning_tpu_torch" / "configs" / "dofa_upernet_waterloo.yaml"
SPLITS = {"trn": 6, "val": 3, "tst": 3}  # batch 2: 3 train steps an epoch, padded val/tst


def _dataset(root: Path) -> None:
    rng = np.random.default_rng(0)
    for split, n in SPLITS.items():
        rows = []
        for kind in ("image", "label"):
            (root / split / kind).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            write_geotiff(root / split / "image" / f"{i}.tif",
                          rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
            write_geotiff(root / split / "label" / f"{i}_lbl.tif",
                          rng.integers(0, 2, (64, 64), dtype=np.uint8))
            rows.append(f"{split}/image/{i}.tif;{split}/label/{i}_lbl.tif")
        (root / f"{split}.csv").write_text("\n".join(rows) + "\n")


@pytest.fixture
def config(tmp_path, monkeypatch):
    register_tiny(monkeypatch)
    _dataset(tmp_path / "data")
    cfg = load_config(PORT_CONFIG)
    cfg["trainer"].update(default_root_dir=str(tmp_path / "run"), max_epochs=2,
                          precision="32-true")
    cfg["model"]["init_args"].update(encoder="tiny", image_size=[64, 64], decoder_channels=32)
    cfg["data"]["init_args"].update(csv_root_folder=str(tmp_path / "data"),
                                    patches_root_folder=str(tmp_path / "data"), batch_size=2,
                                    patch_size=[64, 64])
    return cfg


def _ckpt_dir(config) -> Path:
    return Path(config["trainer"]["default_root_dir"]) / "checkpoints"


def test_fit_then_test_from_the_best_checkpoint(config):
    result = cli.run(copy.deepcopy(config), "fit", device="cpu")
    for key in ("train_loss", "val_loss", "val_miou", "test_loss", "test_miou",
                "test_iou_building", "test_accuracy", "test_mf1"):
        assert np.isfinite(result[key]), key
    ckpts = _ckpt_dir(config)
    index = json.loads((ckpts / "index.json").read_text())
    best = Path(index["best_path"])
    assert best.exists() and (ckpts / "last.pt").exists()
    assert index["monitor"] == "val_loss"
    assert len(list(ckpts.glob("model-epoch=*.pt"))) == 1  # save_top_k = 1
    last = torch.load(ckpts / "last.pt", weights_only=True)
    assert last["step"] == 2 * 3
    assert last["plateau"] is not None and last["optimizer"]["state"]

    # the restored best reproduces the auto-test exactly (same weights, same data)
    tested = cli.run(copy.deepcopy(config), "test", device="cpu", ckpt_path=str(best))
    assert tested == {k: v for k, v in result.items() if k.startswith("test_")}
    validated = cli.run(copy.deepcopy(config), "validate", device="cpu", ckpt_path=str(best))
    assert np.isfinite(validated["val_loss"]) and "val_iou_building" in validated


def test_fit_resumes_from_last(config):
    cli.run(copy.deepcopy(config), "fit", device="cpu")
    last = _ckpt_dir(config) / "last.pt"
    resumed = copy.deepcopy(config)
    resumed["trainer"]["max_epochs"] = 1
    resumed["ckpt_path"] = str(last)
    cli.run(resumed, "fit", device="cpu")
    assert torch.load(last, weights_only=True)["step"] == 2 * 3 + 3


def test_fit_trains_only_what_is_not_frozen(config):
    config["model"]["init_args"]["freeze_layers"] = ["encoder"]
    config["trainer"]["max_epochs"] = 1
    cli.run(copy.deepcopy(config), "fit", device="cpu")
    state = torch.load(_ckpt_dir(config) / "last.pt", weights_only=True)
    fresh = cli.instantiate(config["model"])
    fresh.task.materialize(torch.device("cpu"), config["seed_everything"])
    before = fresh.task.model.state_dict()
    moved = {k for k, v in state["model"].items()
             if v.is_floating_point() and not torch.equal(v, before[k])}
    assert moved and not any(k.startswith("encoder.") for k in moved)
    assert any(k.startswith("decoder.") and "running_mean" in k for k in moved)
