"""The port's ``GrainCSVDataModule`` (spawned worker processes) on the CPU.

Train batches of two epochs equal the threaded ``CSVDataModule``'s bit for
bit; val and test batches equal the JAX ``CSVDataset``'s samples collated
as the JAX ``_collate_grain`` collates them, in order, with a short last
batch, the same ``valid_count`` and the JAX ``_EpochIterable.__len__``,
with and without ``device_preprocess``. A worker's exception reaches the
consumer, a killed worker raises within the time limit, the workers
persist across passes (an early break too), and no child process is left
after ``close()``, a failed pass or ``run(config, "fit", "cpu")`` on the
JAX class path. 32x32 patches, 10/5/5 rows, 2 workers, one module
of each kind for the file so that its workers start once; every wait has
a time limit (no pytest-timeout here).
"""

import copy
import json
import multiprocessing
import os
import signal
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from _torch_tiny import register_tiny

from geo_deep_learning_tpu.data.csv_dataset import CSVDataset as JaxCSVDataset
from geo_deep_learning_tpu.data.grain_pipeline import GrainCSVDataModule as JaxGrain
from geo_deep_learning_tpu.data.grain_pipeline import _collate_grain
from geo_deep_learning_tpu_torch.cli import main as cli
from geo_deep_learning_tpu_torch.cli.config import import_class, load_config
from geo_deep_learning_tpu_torch.data.datamodule import CSVDataModule
from geo_deep_learning_tpu_torch.data.geotiff import write_geotiff
from geo_deep_learning_tpu_torch.data.grain_pipeline import BATCH_TIMEOUT_S, GrainCSVDataModule

ROOT = Path(__file__).resolve().parents[1]
PORT_CONFIG = ROOT / "geo_deep_learning_tpu_torch" / "configs" / "dofa_upernet_waterloo.yaml"
JAX_CLASS = "geo_deep_learning_tpu.data.grain_pipeline.GrainCSVDataModule"
SPLITS = {"trn": 10, "val": 5, "tst": 5}
STATS = {"mean": [0.4, 0.45, 0.5], "std": [0.2, 0.25, 0.3]}


def _write(root: Path, splits: dict, size: int) -> Path:
    rng = np.random.default_rng(0)
    for split, n in splits.items():
        (root / split).mkdir(parents=True)
        rows = []
        for i in range(n):
            img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
            write_geotiff(root / split / f"{i}.tif", img)
            write_geotiff(root / split / f"{i}_lbl.tif", rng.integers(0, 2, (size, size),
                                                                       dtype=np.uint8))
            rows.append(f"{split}/{i}.tif;{split}/{i}_lbl.tif")
        (root / f"{split}.csv").write_text("\n".join(rows) + "\n")
    return root


@pytest.fixture(scope="module")
def data(tmp_path_factory) -> Path:
    return _write(tmp_path_factory.mktemp("grain"), SPLITS, 32)


def _module(cls, root: Path, device_preprocess: bool = True, **kw):
    kw = {"batch_size": 4, "num_workers": 2, **STATS, "device_preprocess": device_preprocess,
          **kw}
    dm = cls(str(root), str(root), **kw)
    dm.setup("fit")
    return dm


@pytest.fixture(scope="module")
def grain(data):
    dm = _module(GrainCSVDataModule, data)
    yield dm
    dm.close()


@pytest.fixture(scope="module")
def grain_f32(data):
    dm = _module(GrainCSVDataModule, data, device_preprocess=False)
    yield dm
    dm.close()


def _children() -> set:
    return set(multiprocessing.active_children())


def _new_children(before: set, limit: float = 5.0) -> set:
    """Child processes beyond ``before`` still alive after up to ``limit`` s."""
    end = time.monotonic() + limit
    while (left := _children() - before) and time.monotonic() < end:
        time.sleep(0.05)
    return left


def _same(got, want, dtype=None) -> bool:
    """Equal values, shapes and dtype (``dtype`` where the port's differs)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    if isinstance(want, np.ndarray):
        return (got.dtype == (dtype or want.dtype) and got.shape == want.shape
                and np.array_equal(got, want))
    return list(got) == list(want) if isinstance(want, list) else got == want


def test_train_batches_equal_the_threaded_loaders(grain, data):
    threaded = _module(CSVDataModule, data)
    got_loader, want_loader = grain.train_dataloader(), threaded.train_dataloader()
    assert len(got_loader) == len(want_loader) == 2
    for _ in range(2):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert all(_same(g[k], w[k]) for k in w), [k for k in w if not _same(g[k], w[k])]
            assert isinstance(g["image"], torch.Tensor) and g["image"].dtype == torch.uint8
    assert got_loader.epoch == want_loader.epoch == 2
    assert grain.startup_s is not None and 0 < grain.startup_s < BATCH_TIMEOUT_S


@pytest.mark.parametrize("device_preprocess", [True, False])
@pytest.mark.parametrize("split", ["val", "tst"])
def test_eval_batches_equal_the_jax_datasets(request, data, split, device_preprocess):
    dm = request.getfixturevalue("grain" if device_preprocess else "grain_f32")
    loader = dm.val_dataloader() if split == "val" else dm.test_dataloader()
    jax_ds = JaxCSVDataset(str(data), str(data), split=split, norm_stats=STATS,
                           device_preprocess=device_preprocess)
    jax_len = JaxGrain._EpochIterable(SimpleNamespace(datasets={split: jax_ds}, batch_size=4),
                                      split, False, False)
    samples = [jax_ds[i] for i in range(len(jax_ds))]
    want = [_collate_grain(samples[i : i + 4]) for i in range(0, len(samples), 4)]
    got = list(loader)
    assert len(loader) == len(jax_len) == len(want) == len(got) == 2
    assert [b["valid_count"] for b in got] == [int(b["valid_count"]) for b in want] == [4, 1]
    assert got[-1]["image"].shape[0] == 1
    for g, w in zip(got, want):
        for key in ("image", "mean", "std", "image_name", "mask_name"):
            assert _same(g[key], w[key]), key
        # masks: torch's index type in the port, JAX's int32 in the JAX package
        assert _same(g["mask"], w["mask"], np.int64)


def test_early_break_keeps_the_workers_and_an_exception_reaches_the_consumer(tmp_path):
    """A pass left early keeps the worker for the next pass; a worker's
    exception (a missing patch) is raised in the consumer with its message
    and closes the workers."""
    root = _write(tmp_path, {"trn": 4, "val": 4}, 8)
    (root / "val" / "2.tif").unlink()
    before = _children()
    dm = _module(GrainCSVDataModule, root, batch_size=2, num_workers=1)
    try:
        for _ in dm.train_dataloader():
            break
        workers = _children() - before
        assert len(workers) == 1, "the worker persists across passes"
        assert [b["valid_count"] for b in dm.train_dataloader()] == [2, 2]
        assert _children() - before == workers, "a pass after an early break restarted it"
        with pytest.raises(FileNotFoundError, match="2.tif"):
            list(dm.val_dataloader())
        assert not _new_children(before), "a failed pass leaves its worker alive"
    finally:
        dm.close()


def test_a_killed_worker_raises_within_the_timeout(data):
    dm = _module(GrainCSVDataModule, data, batch_size=1, num_workers=1)
    before = _children()
    it = iter(dm.train_dataloader())
    try:
        next(it)
        worker = (_children() - before).pop()
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="DataLoader worker"):
            os.kill(worker.pid, signal.SIGKILL)
            for _ in it:
                time.sleep(0.05)
        assert time.monotonic() - t0 < BATCH_TIMEOUT_S
    finally:
        it.close()
        dm.close()
    assert not _new_children(before)


def test_one_split_at_a_time(grain):
    train = iter(grain.train_dataloader())
    next(train)
    with pytest.raises(RuntimeError, match="one split at a time"):
        next(iter(grain.val_dataloader()))
    train.close()
    assert [b["valid_count"] for b in grain.val_dataloader()] == [4, 1]


def test_fit_on_the_jax_class_path_leaves_no_worker(tmp_path, monkeypatch):
    """``run(config, "fit", "cpu")`` with the data node naming the JAX
    class: it trains and tests through the port's module, no worker process
    is left after the run, and its auto-test (short last batch) equals
    ``test`` of its best checkpoint through ``CSVDataModule`` (padded last
    batch)."""
    assert import_class(JAX_CLASS) is GrainCSVDataModule
    register_tiny(monkeypatch)
    root = _write(tmp_path / "data", {"trn": 2, "val": 1, "tst": 1}, 32)
    cfg = load_config(PORT_CONFIG)
    cfg["trainer"].update(max_epochs=1, precision="32-true", default_root_dir=str(tmp_path))
    cfg["model"]["init_args"].update(encoder="tiny", image_size=[32, 32], decoder_channels=8)
    cfg["data"]["init_args"].update(csv_root_folder=str(root), patches_root_folder=str(root),
                                    batch_size=2, patch_size=[32, 32], num_workers=1)
    threads = copy.deepcopy(cfg)
    cfg["data"]["class_path"] = JAX_CLASS
    before = _children()
    result = cli.run(cfg, "fit", device="cpu")
    assert not _new_children(before)
    assert {"train_loss", "val_loss", "test_loss", "test_miou"} <= set(result)
    assert all(np.isfinite(v) for v in result.values())
    best = json.loads((tmp_path / "checkpoints" / "index.json").read_text())["best_path"]
    tested = cli.run(threads, "test", device="cpu", ckpt_path=best)
    for key, value in tested.items():
        assert result[key] == pytest.approx(value, rel=1e-6, abs=1e-6), key
