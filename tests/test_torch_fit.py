"""The port's ``fit`` / ``validate`` / ``test`` / ``predict`` subcommands
end to end on the CPU: a tiny DOFA + UperNet and a narrow SegFormer on
synthetic GeoTIFF datasets with ``trn`` / ``val`` / ``tst`` splits, through
``run(config, ...)`` as a user calls it, with the port configs' trainer,
optimizer and scheduler."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_tiny import register_tiny, register_tiny_mit

from geo_deep_learning_tpu_torch.cli import main as cli
from geo_deep_learning_tpu_torch.cli.config import load_config
from geo_deep_learning_tpu_torch.data.geotiff import write_geotiff

ROOT = Path(__file__).resolve().parents[1]
PORT_CONFIG = ROOT / "geo_deep_learning_tpu_torch" / "configs" / "dofa_upernet_waterloo.yaml"
SEGFORMER_CONFIG = ROOT / "geo_deep_learning_tpu_torch" / "configs" / "segformer_waterloo.yaml"
SPLITS = {"trn": 6, "val": 3, "tst": 3}  # batch 2: 3 train steps an epoch, padded val/tst


def _dataset(root: Path, size: int = 64) -> None:
    rng = np.random.default_rng(0)
    for split, n in SPLITS.items():
        rows = []
        for kind in ("image", "label"):
            (root / split / kind).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            write_geotiff(root / split / "image" / f"{i}.tif",
                          rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
            write_geotiff(root / split / "label" / f"{i}_lbl.tif",
                          rng.integers(0, 2, (size, size), dtype=np.uint8))
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


@pytest.fixture
def segformer_config(tmp_path, monkeypatch):
    """The SegFormer port config at the narrow MiT on 128^2 patches (stage 1
    attends 1024 queries: the K10 dispatch, its plain version here)."""
    register_tiny_mit(monkeypatch)
    _dataset(tmp_path / "data", size=128)
    cfg = load_config(SEGFORMER_CONFIG)
    cfg["trainer"].update(default_root_dir=str(tmp_path / "run"), max_epochs=2,
                          precision="32-true")
    cfg["model"]["init_args"].update(encoder="tiny_mit", image_size=[128, 128])
    cfg["data"]["init_args"].update(csv_root_folder=str(tmp_path / "data"),
                                    patches_root_folder=str(tmp_path / "data"), batch_size=2,
                                    patch_size=[128, 128])
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


class _Items:
    """12 samples that carry their own index."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        return {"i": np.asarray(i), "mask": np.zeros((2, 2), np.int64)}


class _Data:
    """A datamodule over :class:`_Items`: shuffled, drop_last train loader
    (bs 4, seed 42) and one validation batch."""

    def setup(self, stage):
        pass

    def train_dataloader(self):
        from geo_deep_learning_tpu_torch.data.loader import DataLoader

        return DataLoader(_Items(), batch_size=4, shuffle=True, drop_last=True, seed=42)

    def val_dataloader(self):
        return [{"mask": np.zeros((1, 2, 2), np.int64), "valid_count": 1}]


class _Weight(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))

    def init_weights(self, generator):
        with torch.no_grad():
            self.w.zero_()


def test_fit_trains_in_the_jax_fit_sample_order(tmp_path, monkeypatch):
    """The JAX ``fit`` peeks at one batch before its first epoch, which uses
    up its loader's epoch 0; the port's ``fit`` must train each epoch on the
    same samples in the same order, resumed or not."""
    from geo_deep_learning_tpu.data.loader import DataLoader as JaxLoader
    from geo_deep_learning_tpu_torch.ops.losses import DiceLoss
    from geo_deep_learning_tpu_torch.training import loop
    from geo_deep_learning_tpu_torch.training.task import SegmentationTask

    seen = []

    def train_step(state, batch):
        seen.append(batch["i"].tolist())
        state.step += 1
        return {"loss": torch.zeros(())}

    def eval_step(batch):
        return {"loss": torch.zeros(()), "confusion": torch.zeros((2, 2))}

    monkeypatch.setattr(loop, "make_train_step", lambda *a, **k: train_step)
    monkeypatch.setattr(loop, "make_eval_step", lambda *a, **k: eval_step)

    def fit(epochs, ckpt_path=None):
        seen.clear()
        cfg = loop.TrainerConfig(max_epochs=epochs, checkpoint_dir=str(tmp_path / "ckpt"),
                                 auto_test_after_fit=False)
        task = SegmentationTask(_Weight(), DiceLoss(mode="binary"), uses_wavelengths=False)
        loop.Trainer(cfg, device="cpu").fit(task, _Data(), ckpt_path=ckpt_path)
        return list(seen)

    def jax_fit(epochs):
        loader = JaxLoader(_Items(), batch_size=4, shuffle=True, drop_last=True, num_workers=1,
                           seed=42)
        next(iter(loader))  # the peek of geo_deep_learning_tpu/training/loop.py::Trainer.fit
        return [b["i"].tolist() for _ in range(epochs) for b in loader]

    want = jax_fit(2)
    assert len(want) == 6 and sorted(sum(want[:3], [])) == list(range(12))
    assert fit(2) == want
    assert fit(1, ckpt_path=str(tmp_path / "ckpt" / "last.pt")) == jax_fit(1)


def test_segformer_fit_test_validate_predict(segformer_config, monkeypatch):
    """SegFormer through every subcommand: ``fit`` with its auto-test, the
    restored best checkpoint's ``test`` equal to it, ``validate``, and
    ``predict`` rasters; every forward takes the K10 dispatch once."""
    from geo_deep_learning_tpu_torch.ops.cuda import sr_attention as tsra

    calls = []
    plain = tsra.sr_attention_plain
    monkeypatch.setattr(tsra, "sr_attention_plain", lambda *a: calls.append(1) or plain(*a))
    config = segformer_config
    result = cli.run(copy.deepcopy(config), "fit", device="cpu")
    for key in ("train_loss", "val_loss", "val_miou", "test_loss", "test_miou",
                "test_iou_building", "test_accuracy", "test_mf1"):
        assert np.isfinite(result[key]), key
    # 2 epochs x 3 train steps, 2 x 2 val batches, 2 test batches
    assert len(calls) == 6 + 4 + 2
    best = json.loads((_ckpt_dir(config) / "index.json").read_text())["best_path"]
    last = torch.load(_ckpt_dir(config) / "last.pt", weights_only=True)
    assert last["step"] == 2 * 3 and not any(k.startswith("aux") for k in last["model"])
    tested = cli.run(copy.deepcopy(config), "test", device="cpu", ckpt_path=best)
    assert tested == {k: v for k, v in result.items() if k.startswith("test_")}
    validated = cli.run(copy.deepcopy(config), "validate", device="cpu", ckpt_path=best)
    assert np.isfinite(validated["val_loss"]) and "val_iou_building" in validated
    predicted = cli.run(copy.deepcopy(config), "predict", device="cpu")
    files = sorted(Path(predicted["output_dir"]).glob("*_pred.tif"))
    assert predicted["num_predictions"] == SPLITS["tst"] == len(files)


def test_segformer_weights_fall_back_to_seeded_random(segformer_config, caplog):
    """A ``weights`` name the repository cannot provide logs a warning and
    keeps the seeded random weights: the same metrics as ``weights: null``."""
    config = segformer_config
    plain = cli.run(copy.deepcopy(config), "test", device="cpu")
    config["model"]["init_args"]["weights"] = "imagenet"
    with caplog.at_level("WARNING"):
        named = cli.run(copy.deepcopy(config), "test", device="cpu")
    assert named == plain
    assert any("not in the repository" in r.message for r in caplog.records)
    config["model"]["init_args"]["weights_from_checkpoint_path"] = "some.ckpt"
    with pytest.raises(NotImplementedError):  # warm starts are not ported
        cli.run(copy.deepcopy(config), "test", device="cpu")
