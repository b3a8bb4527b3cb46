"""CSV datamodule: split-aware dataset and loader construction.

Port of ``geo_deep_learning_tpu/data/datamodule.py`` (``CSVDataModule``):
``fit`` reads ``trn`` and ``val`` (and ``tst`` when present, for the
auto-test after fit), ``validate`` reads ``val``, ``test`` / ``predict``
read ``tst``. The train loader shuffles with ``seed`` and drops the last
partial batch; the val and test loaders pad it. Every loader reads with
``num_workers`` threads (default 8, as in the JAX package).
"""

from __future__ import annotations

from typing import Sequence

from geo_deep_learning_tpu_torch.data.csv_dataset import CSVDataset
from geo_deep_learning_tpu_torch.data.loader import DataLoader


class CSVDataModule:
    def __init__(
        self,
        csv_root_folder: str,
        patches_root_folder: str,
        batch_size: int = 4,
        num_workers: int = 8,
        mean: Sequence[float] | None = None,
        std: Sequence[float] | None = None,
        patch_size: Sequence[int] = (512, 512),
        band_indices: Sequence[int] | None = None,
        device_preprocess: bool = False,
        data_type_max: float = 255.0,
        seed: int = 42,
    ) -> None:
        del patch_size  # the patches' own size is used
        self.num_workers = num_workers
        self.csv_root_folder = csv_root_folder
        self.patches_root_folder = patches_root_folder
        self.batch_size = batch_size
        self.norm_stats = {
            "mean": list(mean) if mean is not None else [0.0],
            "std": list(std) if std is not None else [1.0],
        }
        self.band_indices = list(band_indices) if band_indices else None
        self.device_preprocess = device_preprocess
        self.data_type_max = float(data_type_max)
        self.seed = seed
        self.datasets: dict[str, CSVDataset] = {}

    def _make(self, split: str) -> CSVDataset:
        return CSVDataset(
            self.csv_root_folder,
            self.patches_root_folder,
            split=split,
            norm_stats=self.norm_stats,
            band_indices=self.band_indices,
            device_preprocess=self.device_preprocess,
            data_type_max=self.data_type_max,
        )

    def setup(self, stage: str) -> None:
        splits = {"fit": ("trn", "val"), "validate": ("val",), "test": ("tst",),
                  "predict": ("tst",)}
        if stage not in splits:
            msg = f"unknown stage {stage!r}; known: {sorted(splits)}"
            raise ValueError(msg)
        for split in splits[stage]:
            if split not in self.datasets:
                self.datasets[split] = self._make(split)
        if stage == "fit" and "tst" not in self.datasets:
            try:  # the test split is optional at fit time (auto-test after fit)
                self.datasets["tst"] = self._make("tst")
            except FileNotFoundError:
                pass

    def train_dataloader(self) -> DataLoader:
        return DataLoader(self.datasets["trn"], batch_size=self.batch_size, shuffle=True,
                          drop_last=True, num_workers=self.num_workers, seed=self.seed)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self.datasets["val"], batch_size=self.batch_size, pad_partial=True,
                          num_workers=self.num_workers)

    def test_dataloader(self) -> DataLoader:
        if "tst" not in self.datasets:
            self.setup("test")
        return DataLoader(self.datasets["tst"], batch_size=self.batch_size, pad_partial=True,
                          num_workers=self.num_workers)
