"""CSV datamodule: split-aware dataset and loader construction.

Port of ``geo_deep_learning_tpu/data/datamodule.py`` (``CSVDataModule``),
for the stages the port runs so far: ``test`` and ``predict`` read the
``tst`` split. ``num_workers`` is accepted for config compatibility; the
loader is single-process.
"""

from __future__ import annotations

import logging
from typing import Sequence

from geo_deep_learning_tpu_torch.data.csv_dataset import CSVDataset
from geo_deep_learning_tpu_torch.data.loader import DataLoader

logger = logging.getLogger(__name__)


class CSVDataModule:
    def __init__(
        self,
        csv_root_folder: str,
        patches_root_folder: str,
        batch_size: int = 4,
        num_workers: int = 0,
        mean: Sequence[float] | None = None,
        std: Sequence[float] | None = None,
        patch_size: Sequence[int] = (512, 512),
        band_indices: Sequence[int] | None = None,
        device_preprocess: bool = False,
        data_type_max: float = 255.0,
        seed: int = 42,
    ) -> None:
        del patch_size, seed  # config keys the evaluation path does not read
        if num_workers:
            logger.info("num_workers=%s ignored: the port's loader is single-process", num_workers)
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
        self.datasets: dict[str, CSVDataset] = {}

    def setup(self, stage: str) -> None:
        if stage not in ("test", "predict"):
            msg = f"stage {stage!r} is not ported yet (test and predict are)"
            raise ValueError(msg)
        if "tst" not in self.datasets:
            self.datasets["tst"] = CSVDataset(
                self.csv_root_folder,
                self.patches_root_folder,
                split="tst",
                norm_stats=self.norm_stats,
                band_indices=self.band_indices,
                device_preprocess=self.device_preprocess,
                data_type_max=self.data_type_max,
            )

    def test_dataloader(self) -> DataLoader:
        self.setup("test")
        return DataLoader(self.datasets["tst"], batch_size=self.batch_size)
